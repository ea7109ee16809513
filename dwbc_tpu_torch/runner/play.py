"""Policy evaluation / trajectory export.

Counterpart of dwbc_tpu/runner/play.py (mirror of reference
scripts/play.py): loads a checkpoint, runs a few envs with the
deployment-mode policy (history encoder replacing the privileged encoder,
actor_critic.py:204-217), logs per-step state of env 0 into `Logger` and
renders the 3x3 diagnostic figure (play.py:133-171, logger.py:86-151),
and dumps state/command/EE-goal trajectories to .npz for offline
visualization (runner/visualize.py, the viewer replacement).

`--use_jit DIR` plays the exported torch.export program (from
runner/export.py, loaded by its `load_artifact`, the JAX play's
`load_jit_policy`) instead of the live model, the reference's jit-policy
playback path (play.py:106-111, 127-131), after holding it against the
live model on the first batch.

`--stochastic` samples actions from a generator seeded with 1 (the JAX
play's PRNGKey(1) stream; the draws themselves differ between the two
packages). Runs on the NVIDIA GPU and raises without one, unless --cpu is
given.

Usage: python -m dwbc_tpu_torch.runner.play --task widowGo1 --checkpoint
       path
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

# per-step diagnostics of env 0, in the order they are stacked
_LOG_KEYS = ("base_vel_x", "command_x", "base_vel_y", "command_y",
             "base_vel_yaw", "command_yaw", "base_vel_z", "base_height",
             "dof_pos", "dof_pos_target", "dof_vel", "dof_torque",
             "contact_forces_z")


def play(task: str = "widowGo1", checkpoint=None, num_envs: int = 5,
         steps: int = 500, stochastic: bool = False, use_jit=None,
         out: str = "play_traj.npz", device="cuda", plot: bool = True):
    """Play `steps` policy steps of `num_envs` envs and write the npz (and,
    with `plot`, the Logger figure next to it). Returns a summary dict:
    the paths, the env-steps per second of the loop and, with `use_jit`,
    the largest |live - exported| on the first batch."""
    from ..utils.logger import Logger
    from ..utils.task_registry import make_runner
    from .export import load_artifact

    env, runner, _ = make_runner(task, num_envs=num_envs, device=device)
    dev = env.device
    if checkpoint:
        runner.load(checkpoint, load_optimizer=False)
    policy = runner.get_inference_policy(stochastic=stochastic)
    state, obs = env.reset(torch.Generator(device=dev).manual_seed(0))

    summary = {}
    if use_jit:
        if stochastic:
            raise SystemExit("--use_jit plays the deterministic actor")
        program = load_artifact(use_jit, "policy", dev)
        # deployment-artifact proof: exported program == live model
        with torch.no_grad():
            err = float((policy(obs[:1]) - program(obs[:1])).abs().max())
        print(f"use_jit: max |live - exported| on first obs = {err:.2e}")
        if not err < 1e-5:
            raise AssertionError("the exported program diverges from the "
                                 "live model")
        summary["use_jit_max_abs_err"] = err
        policy = torch.no_grad()(program)

    gen = torch.Generator(device=dev).manual_seed(1)
    has_counter = hasattr(env, "curriculum")  # widowGo1 family
    default_dof = env.default_dof_pos
    a_scale = getattr(env, "action_scale", None)
    cols = {k: [] for k in ("q", "commands", "ee_goal_cart", "ee_pos",
                            "foot_forces", "rew")}
    logged = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(steps):
        actions = policy(obs, gen) if stochastic else policy(obs)
        if has_counter:
            state, out_t = env.step(state, actions, 1e9)
        else:
            state, out_t = env.step(state, actions)
        obs = out_t.obs
        q, qd, cmd = state.robot.q, state.robot.qd, state.commands
        act0 = actions[0]
        j = min(1, act0.shape[0] - 1)
        scale = (0.25 if a_scale is None
                 else a_scale[min(j, a_scale.shape[0] - 1)])
        logged.append(torch.stack([
            qd[0, 0], cmd[0, 0], qd[0, 1],
            cmd[0, 1] if cmd.shape[1] > 1 else torch.zeros_like(cmd[0, 0]),
            qd[0, 5], cmd[0, 2], qd[0, 2], q[0, 2], q[0, 7 + 1],
            scale * act0[j] + default_dof[1], qd[0, 6 + 1],
            state.torques[0, 1], state.foot_forces[0, :, 2].max()]))
        cols["q"].append(q)
        cols["commands"].append(cmd)
        if hasattr(state, "curr_ee_goal_cart"):
            cols["ee_goal_cart"].append(state.curr_ee_goal_cart)
            cols["ee_pos"].append(env._ee_world(q)[0])
        cols["foot_forces"].append(state.foot_forces)
        cols["rew"].append(out_t.rew)
    host = {k: torch.stack(v).cpu().numpy() if v else np.zeros(0)
            for k, v in cols.items()}
    logged = torch.stack(logged).cpu().numpy()
    seconds = time.time() - t0

    logger = Logger(env.dt)
    for row in logged:
        logger.log_states(dict(zip(_LOG_KEYS, row)))
    np.savez(out, **host, dt=env.dt)
    png = None
    if plot:
        png = logger.plot_states(os.path.splitext(out)[0] + "_states.png")
    rate = steps * num_envs / seconds
    print(f"wrote {out}: q {host['q'].shape}, mean reward "
          f"{host['rew'].mean():.4f}, {rate:.0f} env-steps/s"
          + (f"; diagnostics -> {png}" if png else ""))
    print(f"visualize with: python -m dwbc_tpu_torch.runner.visualize {out}")
    summary.update(npz=out, png=png, seconds=seconds, env_steps_per_s=rate)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="widowGo1")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num_envs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--use_jit", default=None, metavar="EXPORT_DIR",
                    help="play back the exported torch.export policy from "
                         "this export dir (validates the deployment "
                         "artifact end-to-end)")
    ap.add_argument("--out", default="play_traj.npz")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    return play(args.task, args.checkpoint, args.num_envs, args.steps,
                args.stochastic, args.use_jit, args.out,
                device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
