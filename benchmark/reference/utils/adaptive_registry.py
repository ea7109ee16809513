"""The adaptive widowGo1 task the benchmark runs, beside
utils/task_registry.py (widowGo1 and go1): widowGo1_adaptive, the
paper's variant with adaptive arm gains and OSC torque supervision
(widowGo1_config.py:162-173 flags).

Its env is envs/widowgo1_adaptive.py with the two flags on and 24
actions, the 6 more entering the proprioception like any action (82, and
82 x 11 + 24 = 926 observations). Its PPO is widowGo1's with the
supervision and the adaptive forward model on and a 24-wide std floor:
widowGo1's 18 values and 0.05 for each of the 6 gain dims. The
supervision's weight follows the published schedule (0, 1000, 1000): it
is 0 from the start, and the branch still runs in every minibatch.
"""

from __future__ import annotations

import dataclasses

from ..envs import config as env_config
from ..rl import ppo as ppo_lib
from . import task_registry

TASKS = ("widowGo1_adaptive",)

PPO = dataclasses.replace(
    task_registry.TASKS["widowGo1"].ppo_cfg,
    torque_supervision=True, adaptive_arm_gains=True,
    min_policy_std=tuple([0.15, 0.25, 0.25] * 4 + [0.2] * 3 + [0.05] * 3
                         + [0.05] * 6))


def adaptive_cfg() -> env_config.WidowGo1Cfg:
    cfg = env_config.WidowGo1Cfg()
    return dataclasses.replace(
        cfg,
        control=dataclasses.replace(cfg.control, adaptive_arm_gains=True,
                                    torque_supervision=True),
        env=dataclasses.replace(cfg.env, num_actions=24,
                                num_proprio=cfg.env.num_proprio + 6))


def make_runner(task: str, num_envs: int, seed: int = 1, device="cuda"):
    """(env, runner, None) of widowGo1_adaptive, built on `device`."""
    from ..envs.widowgo1_adaptive import WidowGo1AdaptiveEnv
    from ..rl.runner import OnPolicyRunner
    if task not in TASKS:
        raise KeyError(f"no adaptive task {task!r}; known: {TASKS}")
    widow = task_registry.TASKS["widowGo1"]
    env = WidowGo1AdaptiveEnv(adaptive_cfg(), num_envs=num_envs, seed=seed,
                              device=device)
    runner = OnPolicyRunner(env, PPO,
                            num_steps_per_env=widow.num_steps_per_env,
                            seed=seed)
    return env, runner, None
