"""Task registry: name -> (env factory, ppo config, runner settings),
cut to the two tasks the benchmark's configurations run: widowGo1 (the
dual-head task) and go1 (the legged rough-terrain family's robot).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from ..envs import legged_config as lc
from ..rl import ppo as ppo_lib


class TaskSpec(NamedTuple):
    make_env: Callable  # (num_envs, seed, device) -> env
    ppo_cfg: ppo_lib.PPOConfig
    num_steps_per_env: int
    default_num_envs: int
    experiment_name: str


def _widow_env(num_envs, seed, device):
    from ..envs.config import WidowGo1Cfg
    from ..envs.widowgo1 import WidowGo1Env
    return WidowGo1Env(WidowGo1Cfg(), num_envs=num_envs, seed=seed,
                       device=device)


def _go1_env(num_envs, seed, device):
    from ..envs.legged_robot import LeggedRobotEnv
    return LeggedRobotEnv(lc.go1_rough(), num_envs=num_envs, seed=seed,
                          device=device)


_WIDOW_PPO = ppo_lib.PPOConfig()  # widowGo1_config.py:343-366 leaves

_BASE_PPO = ppo_lib.PPOConfig(
    # LeggedRobotCfgPPO.algorithm (legged_robot_config.py:214-227)
    entropy_coef=0.01, learning_rate=5e-4, schedule="adaptive",
    desired_kl=0.01, num_heads=1, use_dagger=False, use_roa=False,
    min_policy_std=(0.0,) * 12, mixing_schedule=(0.0, 0.0, 1.0),
    priv_reg_coef_schedule=(0.0, 0.0, 0.0, 1.0))


TASKS: Dict[str, TaskSpec] = {
    "widowGo1": TaskSpec(_widow_env, _WIDOW_PPO, 40, 5000, "rough_widowGo1"),
    "go1": TaskSpec(_go1_env, _BASE_PPO, 24, 4096, "rough_go1"),
}


def make_runner(task: str, num_envs=None, seed: int = 1, log_dir=None,
                device="cuda"):
    """(env, runner, spec) of a registered task, built on `device`."""
    from ..rl.runner import OnPolicyRunner
    spec = TASKS[task]
    env = spec.make_env(num_envs or spec.default_num_envs, seed, device)
    runner = OnPolicyRunner(env, spec.ppo_cfg,
                            num_steps_per_env=spec.num_steps_per_env,
                            log_dir=log_dir, seed=seed)
    return env, runner, spec
