"""Training entry point.

Usage: python -m dwbc_tpu_torch.runner.train --task widowGo1 --num_envs 8192
       --max_iterations 40000 --exptid my_run

Counterpart of dwbc_tpu/runner/train.py with the same flags (mirror of
reference scripts/train.py + the CLI whitelist in helpers.py:153-185:
task, num_envs, seed, max_iterations, resume, run naming). --task takes
every name of utils.task_registry.TASKS: the widowGo1 family, the legged
robots (go1, a1, anymal_c, anymal_b, cassie; rough and flat) and
go1_flat_lstm, which trains the recurrent policy through RecurrentRunner.
Runs on the NVIDIA GPU and raises without one, unless --cpu is given.

Several GPUs: torchrun --nproc_per_node=K -m dwbc_tpu_torch.runner.train
--task go1 --num_envs 8192 ... starts one process per GPU; with --mesh
auto (the default) they train data-parallel, each rank stepping
num_envs / K envs on cuda:LOCAL_RANK, with NCCL (gloo with --cpu) for
the gradient and statistic all-reduces (parallel/distributed.py). Rank 0
logs and writes the checkpoints. --mesh none, or a process started
without torchrun, trains on one device; `torchrun --nproc_per_node=1`
trains on one GPU through the same collectives (NCCL over a group of
one)."""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="widowGo1")
    ap.add_argument("--num_envs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max_iterations", type=int, default=40000)
    ap.add_argument("--exptid", "--run_name", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="explicit checkpoint path for --resume")
    ap.add_argument("--log_root", default="logs")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--headless", action="store_true", help="(always headless)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    ap.add_argument("--mesh", default="auto", choices=["auto", "none"],
                    help="auto: under torchrun train data-parallel over "
                         "the ranks, one GPU each; none (or no launcher): "
                         "one device")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of iterations 5-8 "
                         "into <log_dir>/profile")
    ap.add_argument("--spawn_relative", action="store_true",
                    help="widowGo1 family: spawn at terrain + 0.40 m "
                         "instead of the reference's absolute 0.42 m — "
                         "removes the landing transient that kills many "
                         "fresh spawns within 13 steps")
    ap.add_argument("--droop_comp", action="store_true",
                    help="gravity-droop-compensated PD targets (widowGo1 "
                         "family): stand at the default-pose height the "
                         "config describes instead of sagging tau_g/kp "
                         "below it")
    ap.add_argument("--leg_min_std", type=float, default=None,
                    help="override the min_policy_std floor for the 12 leg "
                         "dofs (reference mechanism, ppo.py:293-296; the "
                         "released floor is [0.15,0.25,0.25]*4). A raised "
                         "floor keeps exploration alive against the "
                         "surrogate's std collapse")
    ap.add_argument("--reset_std", action="store_true",
                    help="after --resume, reset the learned per-joint "
                         "policy std to its init values (exploration "
                         "re-warm: a policy annealed to the min_policy_std "
                         "floor cannot discover new behaviors)")
    ap.add_argument("--reset_schedules", action="store_true",
                    help="after --resume, restart the iteration counter so "
                         "every schedule (advantage-mixing kappa ramp, "
                         "command/EE curricula, priv-reg) replays from 0 "
                         "while keeping the loaded weights — the reference "
                         "recipe's early phase applied to a resumed policy")
    ap.add_argument("--terminal_schedules", action="store_true",
                    help="force all curricula/regularizer schedules to their "
                         "terminal values (the reference's RESUME=True "
                         "semantics, widowGo1_config.py:35)")
    ap.add_argument("--ts_weight", type=float, default=None,
                    help="override torque_supervision_schedule[0] (the "
                         "reference ships 0.0, ppo.py:304; a nonzero value "
                         "actually trains the OSC supervision loss)")
    ap.add_argument("--commit_curves", type=int, default=0, metavar="SEC",
                    help="the JAX CLI's periodic commit of the metric "
                         "curves; not ported: a value above 0 is refused")
    ap.add_argument("--terminal_mixing", action="store_true",
                    help="advantage-mixing ratio kappa=1 from iteration 0 "
                         "(the reference's RESUME-mode mixing_schedule="
                         "[1.0, 0, 1], widowGo1_config.py:360) while other "
                         "schedules keep their fresh-training ramps")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import distributed as dist
    from ..rl.ppo import PPOConfig
    from ..utils.logger import log_files
    from ..utils.task_registry import TASKS, make_runner

    if args.commit_curves > 0:
        raise SystemExit("--commit_curves is not ported: the curve-commit "
                         "tool belongs to the JAX package")
    if args.task not in TASKS:
        raise SystemExit(f"unknown task {args.task!r}; have {list(TASKS)}")
    device = "cpu" if args.cpu else "cuda"
    if args.mesh == "auto":
        # joins the launcher's group (torchrun), a launch of one process
        # included; without a launcher it only resolves the device
        device = dist.initialize(device=device)

    run_name = args.exptid or time.strftime("%b%d_%H-%M-%S")
    log_dir = os.path.join(args.log_root, TASKS[args.task].experiment_name,
                           run_name)
    ppo_overrides = {}
    if args.terminal_mixing:
        # reference RESUME-mode mixing (widowGo1_config.py:360)
        ppo_overrides["mixing_schedule"] = (1.0, 0.0, 1.0)
    if args.ts_weight is not None:
        ppo_overrides["torque_supervision_schedule"] = (
            args.ts_weight, 1000.0, 1000.0)
    if args.leg_min_std is not None:
        base = PPOConfig().min_policy_std
        ppo_overrides["min_policy_std"] = (
            (args.leg_min_std,) * 12 + tuple(base[12:]))

    def env_setup(env):
        # runs before the runner's initial reset, so that the flags shape
        # iteration 0's spawns too
        if args.droop_comp:
            if not hasattr(env, "enable_droop_compensation"):
                raise SystemExit("--droop_comp is only available for the "
                                 "widowGo1 task family")
            env.enable_droop_compensation()
            print("droop compensation ON:",
                  [round(x, 3) for x in env.droop_comp.tolist()])
        if args.spawn_relative:
            if not hasattr(env, "spawn_relative"):
                raise SystemExit("--spawn_relative is only available for "
                                 "the widowGo1 task family")
            env.spawn_relative = True
            print("terrain-relative spawn ON (ground + 0.40 m)")

    env, runner, spec = make_runner(args.task, num_envs=args.num_envs,
                                    seed=args.seed, log_dir=log_dir,
                                    device=device,
                                    ppo_overrides=ppo_overrides or None,
                                    env_setup=env_setup)
    if args.resume:
        ckpt = args.checkpoint or _latest_checkpoint(
            os.path.join(args.log_root, TASKS[args.task].experiment_name))
        print(f"resuming from {ckpt}")
        runner.load(ckpt)
        if args.reset_std:
            with torch.no_grad():
                runner.model.std.copy_(torch.tensor(runner.model.init_std))
            print(f"policy std reset to init {runner.model.init_std}")
        if args.reset_schedules:
            runner.it = 0
            runner.ppo_state.counter = 0
            # range curricula + kappa replay from 0, but the REWARD-SCALE
            # curricula stay terminal: replaying the arm-reward ramp on a
            # value function that already prices it re-creates the
            # net-negative-life trap (see env.curriculum)
            if hasattr(env, "terminal_reward_scales"):
                env.terminal_reward_scales = True
            print("schedules reset: ranges/kappa replay from 0; "
                  "reward-scale curricula pinned terminal")
    if args.terminal_schedules:
        runner.force_terminal_schedules()
    if runner.is_main:
        log_files(log_dir)  # source snapshot (reference logger.py:39-58)
        print(f"task={args.task} num_envs={env.num_envs * dist.world_size()}"
              f" ranks={dist.world_size()} backend={dist.backend()} "
              f"device={env.device} "
              f"steps/env={spec.num_steps_per_env} log_dir={log_dir}",
              flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        runner.learn(5, log_every=args.log_every)
        activities = [ProfilerActivity.CPU]
        if env.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            runner.learn(3, log_every=1)
        prof_dir = os.path.join(log_dir, "profile")
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
        runner.learn(max(args.max_iterations - 8, 0),
                     log_every=args.log_every)
    else:
        runner.learn(args.max_iterations, log_every=args.log_every)
    runner.close()
    dist.shutdown()
    return runner


def _latest_checkpoint(exp_dir: str) -> str:
    """Run/checkpoint discovery by directory listing (helpers.py:103-126)."""
    runs = sorted(
        d for d in os.listdir(exp_dir)
        if os.path.isdir(os.path.join(exp_dir, d)))
    for run in reversed(runs):
        ckpts = [d for d in os.listdir(os.path.join(exp_dir, run))
                 if d.startswith("model_")]
        if ckpts:
            ckpts.sort(key=lambda s: int(s.split("_")[1]))
            return os.path.join(exp_dir, run, ckpts[-1])
    raise FileNotFoundError(f"no checkpoints under {exp_dir}")


if __name__ == "__main__":
    main()
