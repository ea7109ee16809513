"""The recurrent task the benchmark runs, beside utils/task_registry.py
(the feedforward ones): go1_flat_lstm, legged_gym's Go1 on flat ground
trained with rsl_rl's recurrent actor-critic at the published widths.

The env is built from envs/legged_config.go1_rough() as legged_gym's
flat variants are: a plane, no height samples in the observation, no
terrain curriculum (48 observations).
"""

from __future__ import annotations

import dataclasses

from ..envs import legged_config as lc
from . import task_registry

# LeggedRobotCfgPPO.policy (legged_robot_config.py) with the block "only
# for 'ActorCriticRecurrent'": rnn_type 'lstm', rnn_hidden_size 512,
# rnn_num_layers 1
POLICY = dict(rnn_hidden_size=512, actor_hidden_dims=(512, 256, 128),
              critic_hidden_dims=(512, 256, 128), activation="elu",
              init_noise_std=1.0)
TASKS = ("go1_flat_lstm",)


def go1_flat() -> lc.LeggedRobotCfg:
    cfg = lc.go1_rough()
    return dataclasses.replace(
        cfg, terrain=dataclasses.replace(cfg.terrain, mesh_type="plane",
                                         measure_heights=False,
                                         curriculum=False))


def make_runner(task: str, num_envs: int, seed: int = 1, device="cuda"):
    """(env, runner, None) of go1_flat_lstm, built on `device`."""
    from ..envs.legged_robot import LeggedRobotEnv
    from ..rl.recurrent import RecurrentRunner
    if task not in TASKS:
        raise KeyError(f"no recurrent task {task!r}; known: {TASKS}")
    go1 = task_registry.TASKS["go1"]
    env = LeggedRobotEnv(go1_flat(), num_envs=num_envs, seed=seed,
                         device=device)
    runner = RecurrentRunner(env, go1.ppo_cfg,
                             num_steps_per_env=go1.num_steps_per_env,
                             seed=seed, **POLICY)
    return env, runner, None
