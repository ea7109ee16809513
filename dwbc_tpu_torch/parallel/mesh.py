"""Data-parallel layout over the ranks of a torch.distributed job.

Counterpart of dwbc_tpu/parallel/mesh.py. The JAX package places a
global env batch on a ('data',) mesh (`shard_env_state`) and replicates
the parameters (`replicate`); here each rank builds only its own share of
the envs and holds a full replica of the parameters:
  * `env_slice(num_envs_global)`: the rows of the global env batch this
    rank steps (ranks take contiguous blocks in rank order);
  * `replicate(tensors)`: rank 0's values of parameters and optimizer
    state broadcast to every rank, in one bucket per device and dtype.
The JAX `make_mesh` has no counterpart: the process group is the mesh.
`env_slice` replaces `shard_env_state`: no rank ever holds the global
batch to place.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

import torch
import torch.distributed as dist

from . import distributed


def env_slice(num_envs_global: int) -> slice:
    n = distributed.host_env_count(num_envs_global)
    r = distributed.rank()
    return slice(r * n, (r + 1) * n)


def replicate(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite every tensor with rank `src`'s value, in place. Tensors
    are grouped by device and dtype, one broadcast per group (NCCL moves
    a group of host tensors through the rank's GPU)."""
    if not distributed.active():
        return
    nccl = dist.get_backend() == "nccl"
    groups = defaultdict(list)
    for t in tensors:
        groups[(t.device, t.dtype)].append(t)
    for (dev, _), group in groups.items():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        if nccl and dev.type != "cuda":
            flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def state_tensors(module: torch.nn.Module,
                  optimizers: Iterable[torch.optim.Optimizer] = ()):
    """The parameters and buffers of `module` and the state tensors of
    `optimizers`: what `replicate` must make equal across ranks."""
    out = list(module.state_dict().values())
    for opt in optimizers:
        for st in opt.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
    return out
