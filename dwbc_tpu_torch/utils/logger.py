"""Run logging utilities.

Counterpart of dwbc_tpu/utils/logger.py:
  * `log_files` snapshots the package's sources into the run directory
    for reproducibility (reference logger.py:39-58);
  * `Logger` accumulates per-step robot state during evaluation and
    renders the 3x3 diagnostic figure (base vel xy/yaw vs command, dof
    pos/vel/torque, contact forces; reference logger.py:86-151) to a PNG
    instead of an interactive window (headless hosts). It takes numpy
    values, Python numbers or 0-dim tensors; a tensor is copied to the
    host when it is logged. matplotlib is imported only to plot.
"""

from __future__ import annotations

import os
import shutil
from collections import defaultdict

import numpy as np
import torch


def log_files(log_dir: str, repo_root: str | None = None) -> None:
    """Snapshot the dwbc_tpu_torch sources (Python and CUDA/C++) into
    <log_dir>/src."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = repo_root or os.path.dirname(pkg)
    pkg = os.path.join(repo_root, os.path.basename(pkg))
    dst = os.path.join(log_dir, "src")
    os.makedirs(dst, exist_ok=True)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                rel = os.path.relpath(os.path.join(dirpath, f), repo_root)
                out = os.path.join(dst, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copy2(os.path.join(dirpath, f), out)


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        return np.asarray(value.item() if value.dim() == 0
                          else value.detach().cpu().numpy())
    return np.asarray(value)


class Logger:
    """Per-step eval-state capture + diagnostic plot (reference
    logger.py:61-162)."""

    def __init__(self, dt: float):
        self.dt = dt
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key, value):
        self.state_log[key].append(_host(value))

    def log_states(self, d):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d, num_episodes):
        for k, v in d.items():
            self.rew_log[k].append(float(_host(v)) * num_episodes)
        self.num_episodes += num_episodes

    def plot_states(self, out_path: str = "eval_states.png"):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nb_rows, nb_cols = 3, 3
        fig, axs = plt.subplots(nb_rows, nb_cols, figsize=(14, 10))
        log = {k: np.stack(v) for k, v in self.state_log.items()}
        t = np.arange(len(next(iter(log.values())))) * self.dt

        def plot(ax, keys, title, ylabel):
            for k in keys:
                if k in log:
                    ax.plot(t, log[k], label=k)
            ax.set(title=title, xlabel="time [s]", ylabel=ylabel)
            ax.legend(fontsize=7)

        plot(axs[0, 0], ["base_vel_x", "command_x"], "Base vel x", "m/s")
        plot(axs[0, 1], ["base_vel_y", "command_y"], "Base vel y", "m/s")
        plot(axs[0, 2], ["base_vel_yaw", "command_yaw"], "Base yaw vel",
             "rad/s")
        plot(axs[1, 0], ["dof_pos", "dof_pos_target"], "DOF position", "rad")
        plot(axs[1, 1], ["dof_vel"], "DOF velocity", "rad/s")
        plot(axs[1, 2], ["dof_torque"], "DOF torque", "Nm")
        plot(axs[2, 0], ["base_vel_z"], "Base vel z", "m/s")
        plot(axs[2, 1], ["contact_forces_z"], "Contact force z", "N")
        plot(axs[2, 2], ["base_height"], "Base height", "m")
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path

    def print_rewards(self):
        print("Average rewards per second:")
        for k, v in self.rew_log.items():
            print(f"  {k}: {np.sum(np.array(v)) / max(self.num_episodes, 1):.4f}")
