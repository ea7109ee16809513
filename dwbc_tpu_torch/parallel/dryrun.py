"""Multi-rank dry run: one widowGo1 rollout + PPO update, data-parallel.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`: N
ranks of a torch.distributed job, 2 widowGo1 envs each on the plane,
replicated ActorCritic weights, one 2-step `Rollout.collect` and one
`learn_step` (GAE with the job's advantage normalisation, gradients
averaged over the ranks). Checks that the replicas are bitwise equal
afterwards and prints the value loss.

    python -m dwbc_tpu_torch.parallel.dryrun N         # N ranks, N GPUs, NCCL
    python -m dwbc_tpu_torch.parallel.dryrun N --cpu   # N gloo processes

Without --cpu it raises when fewer than N GPUs are visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch


def _worker(rank: int, world: int, store: str, cpu: bool):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from ..envs.config import TerrainCfg, WidowGo1Cfg
    from ..envs.widowgo1 import WidowGo1Env
    from ..models.actor_critic import ActorCritic
    from ..rl import ppo as ppo_lib
    from ..rl.runner import Rollout, rank_generators
    from . import distributed as dist
    from . import mesh

    if cpu:
        torch.set_num_threads(1)
    device = dist.initialize(device="cpu" if cpu else "cuda",
                             init_method=f"file://{store}")
    try:
        cfg = dataclasses.replace(WidowGo1Cfg(),
                                  terrain=TerrainCfg(mesh_type="plane"))
        env = WidowGo1Env(cfg, num_envs=2, seed=0, device=device)
        torch.manual_seed(0)
        model = ActorCritic(num_prop=env.num_proprio,
                            num_priv=env.num_priv).to(device)
        mesh.replicate(mesh.state_tensors(model))
        ppo_cfg = ppo_lib.PPOConfig(num_learning_epochs=1, num_mini_batches=2)
        state = ppo_lib.PPOState(ppo_cfg, model)
        env_gen, noise, perm = rank_generators(device, 0, rank)
        env_state, obs = env.reset(env_gen)
        roll = Rollout(env, model, ppo_cfg, num_steps=2)
        env_state, obs, traj, _, _ = roll.collect(env_state, obs, 0.0, noise,
                                                  hist_encoding=False)
        metrics = roll.learn_step(state, traj, obs, perm, dagger=False)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        ref = flat.clone()
        mesh.replicate([ref])
        if not torch.equal(flat, ref):
            raise AssertionError(f"rank {rank}: parameters differ from "
                                 "rank 0's after the update")
        value_loss = float(metrics["value_loss"])
        if rank == 0:
            print(f"dryrun({world} ranks, {device.type}): OK — "
                  f"value_loss={value_loss:.4f}", flush=True)
    finally:
        dist.shutdown()


def dryrun(n: int, cpu: bool = False) -> None:
    """Run the dry run on `n` ranks: GPUs through NCCL, or with `cpu`
    gloo processes."""
    if not cpu and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun over {n} ranks needs {n} cuda devices, "
                           f"{torch.cuda.device_count()} visible; pass "
                           "--cpu to run it on gloo processes")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(n, os.path.join(tmp, "store"), cpu),
                 nprocs=n, join=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU instead of GPUs")
    args = ap.parse_args(argv)
    dryrun(args.n, args.cpu)


if __name__ == "__main__":
    main()
