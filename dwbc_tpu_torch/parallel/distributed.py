"""Multi-process data-parallel training over torch.distributed.

Counterpart of dwbc_tpu/parallel/distributed.py. The JAX package shards
the env batch over a ('data',) mesh inside one process per host and lets
XLA insert the reductions; PyTorch's idiom is one process per GPU
(`torchrun --nproc_per_node=K`), each stepping its own share of the envs
with a replica of the parameters, and the few global reductions written
out: the gradient and loss-statistic means of every minibatch, the
global advantage normalisation, the command curriculum's counts and the
logged sums.

  * `initialize()` joins the process group when a launcher (torchrun)
    started the process (NCCL on the GPUs, gloo on the CPU), a group of
    one rank included; a process started without one is a no-op.
  * `active()`: whether this process is in a process group. It is the
    one test of a data-parallel run, for every module of the port: the
    env's curriculum, GAE, the updates and the runners reduce over the
    ranks exactly when it holds (a group of one included).
  * `rank()`, `world_size()`, `is_main()`: rank-0 gating for logging and
    checkpoints (a job's side effects happen once, not once per rank).
  * `host_env_count()`: the rank's share of the global env batch.
  * `all_reduce_sum()` / `all_reduce_mean()`: one flattened bucket, one
    collective, in place.

The JAX module's `host_build` (eager construction on the host CPU for a
remote-attached TPU), `cpu_device` (the JAX CPU backend's device) and
`make_global_array` (assembling a global jax.Array from per-host shards)
have no counterpart: torch builds on the device it is given, and each
rank keeps its own shard as ordinary tensors. Nor has `global_mesh`: the
process group is the mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(backend: Optional[str] = None, device="cuda",
               init_method: Optional[str] = None) -> torch.device:
    """Join the process group of a launch (torchrun) and return this
    rank's device. Without WORLD_SIZE in the environment (no launcher)
    nothing is joined and the device is `device` as given; a launch of
    one process joins a group of one, so that its collectives run.

    Under a launcher (RANK, WORLD_SIZE, LOCAL_RANK, and MASTER_ADDR /
    MASTER_PORT unless `init_method` names a store), `device="cuda"` is
    cuda:LOCAL_RANK and the backend NCCL; `device="cpu"` takes gloo. An
    explicit `backend` is honoured, and an explicit device index (say
    "cuda:0") is kept. A rank that finds no GPU raises, and so does a
    backend that fails to initialise."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(dev)
    world = _env_int("WORLD_SIZE", 1)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {_env_int('RANK', 0)} wants {dev}, "
                               f"but {torch.cuda.device_count()} GPU(s) "
                               "are visible")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://",
            rank=_env_int("RANK", 0), world_size=world)
    return dev


def shutdown() -> None:
    """Leave the process group (end of a run)."""
    if active():
        dist.destroy_process_group()


def active() -> bool:
    """True inside a process group (a group of one included)."""
    return dist.is_initialized()


def backend() -> str:
    """The process group's backend ("nccl", "gloo"), or "none"."""
    return dist.get_backend() if active() else "none"


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """True on exactly one process (rank 0): gate logging/ckpt writes."""
    return rank() == 0


def host_env_count(num_envs_global: int) -> int:
    """This rank's env count; the global batch must divide evenly."""
    n = world_size()
    if num_envs_global % n:
        raise ValueError(f"num_envs={num_envs_global} not divisible by "
                         f"{n} ranks")
    return num_envs_global // n


def _all_reduce(tensors: Sequence[torch.Tensor], mean: bool):
    tensors = [t for t in tensors if t is not None]
    if not active() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    # async on the device: NCCL's wait() only orders the current stream
    dist.all_reduce(flat, async_op=True).wait()
    if mean:
        flat /= world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def all_reduce_sum(tensors: Sequence[torch.Tensor]):
    """Sum each tensor over the ranks, in place, in one collective (the
    tensors share a device and dtype). A process outside a group changes
    nothing."""
    return _all_reduce(tensors, mean=False)


def all_reduce_mean(tensors: Sequence[torch.Tensor]):
    """Average each tensor over the ranks, in place, in one collective."""
    return _all_reduce(tensors, mean=True)
