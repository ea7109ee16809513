"""Task registry: name -> (env factory, ppo config, runner settings).

Counterpart of dwbc_tpu/utils/task_registry.py, with the same 12 tasks:
widowGo1 (flagship dual-head task, with its flat and adaptive variants)
plus the generic locomotion family and its recurrent variant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple

from ..envs import legged_config as lc
from ..rl import ppo as ppo_lib
from . import spans


class TaskSpec(NamedTuple):
    make_env: Callable  # (num_envs, seed, device) -> env
    ppo_cfg: ppo_lib.PPOConfig
    num_steps_per_env: int
    default_num_envs: int
    experiment_name: str
    # the reference selects the recurrent variant by name through config
    # (policy_class_name, on_policy_runner.py:63)
    policy_class_name: str = "ActorCritic"


def _widow_env(num_envs, seed, device, terrain=None, adaptive=False):
    from ..envs.config import (ControlCfg, EnvCfg, TerminationCfg,
                               TerrainCfg, WidowGo1Cfg)
    from ..envs.widowgo1 import WidowGo1Env
    cfg = WidowGo1Cfg()
    if terrain is not None:
        cfg = dataclasses.replace(cfg, terrain=TerrainCfg(mesh_type=terrain))
    if terrain == "plane":
        # the reference has NO flat widow config; its absolute
        # z_threshold=0.325 was tuned against the Perlin height
        # distribution, where terrain diversity hands some envs 0.2+ m of
        # margin. On a plane every env shares the same 0.06 m knife-edge.
        # 0.25 still terminates true collapses (go1 trunk bottoms out
        # ~0.12) while restoring the exploration window the rough task
        # gets from terrain diversity.
        cfg = dataclasses.replace(
            cfg, termination=TerminationCfg(z_threshold=0.25))
    if adaptive:
        # adaptive arm gains + OSC torque supervision variant
        # (widowGo1_config.py:168-169 flags; actions widen to 18+6, the
        # extra dims entering proprio like any action)
        cfg = dataclasses.replace(
            cfg,
            control=ControlCfg(adaptive_arm_gains=True,
                               torque_supervision=True),
            env=EnvCfg(num_actions=24, num_proprio=76 + 6))
    return WidowGo1Env(cfg, num_envs=num_envs, seed=seed, device=device)


def _legged_env(cfg_fn):
    def make(num_envs, seed, device):
        from ..envs.legged_robot import LeggedRobotEnv
        return LeggedRobotEnv(cfg_fn(), num_envs=num_envs, seed=seed,
                              device=device)
    return make


_WIDOW_PPO = ppo_lib.PPOConfig()  # widowGo1_config.py:343-366 leaves

_BASE_PPO = ppo_lib.PPOConfig(
    # LeggedRobotCfgPPO.algorithm (legged_robot_config.py:214-227)
    entropy_coef=0.01, learning_rate=5e-4, schedule="adaptive",
    desired_kl=0.01, num_heads=1, use_dagger=False, use_roa=False,
    min_policy_std=(0.0,) * 12, mixing_schedule=(0.0, 0.0, 1.0),
    priv_reg_coef_schedule=(0.0, 0.0, 0.0, 1.0))

_ADAPTIVE_PPO = dataclasses.replace(
    _WIDOW_PPO, torque_supervision=True, adaptive_arm_gains=True,
    min_policy_std=tuple([0.15, 0.25, 0.25] * 4 + [0.2] * 3 + [0.05] * 3
                         + [0.05] * 6))


TASKS: Dict[str, TaskSpec] = {
    "widowGo1": TaskSpec(_widow_env, _WIDOW_PPO, 40, 5000, "rough_widowGo1"),
    "widowGo1_flat": TaskSpec(
        lambda n, s, d: _widow_env(n, s, d, terrain="plane"), _WIDOW_PPO, 40,
        5000, "flat_widowGo1"),
    "widowGo1_adaptive": TaskSpec(
        lambda n, s, d: _widow_env(n, s, d, adaptive=True), _ADAPTIVE_PPO, 40,
        5000, "rough_widowGo1_adaptive"),
    "go1": TaskSpec(_legged_env(lc.go1_rough), _BASE_PPO, 24, 4096, "rough_go1"),
    "go1_flat": TaskSpec(_legged_env(lc.go1_flat), _BASE_PPO, 24, 4096,
                         "flat_go1"),
    "a1": TaskSpec(_legged_env(lc.a1_rough), _BASE_PPO, 24, 4096, "rough_a1"),
    "a1_flat": TaskSpec(_legged_env(lc.a1_flat), _BASE_PPO, 24, 4096,
                        "flat_a1"),
    "anymal_c_rough": TaskSpec(_legged_env(lc.anymal_c_rough), _BASE_PPO, 24,
                               4096, "rough_anymal_c"),
    "anymal_c_flat": TaskSpec(_legged_env(lc.anymal_c_flat), _BASE_PPO, 24,
                              4096, "flat_anymal_c"),
    "anymal_b": TaskSpec(_legged_env(lc.anymal_b_rough), _BASE_PPO, 24, 4096,
                         "rough_anymal_b"),
    "cassie": TaskSpec(_legged_env(lc.cassie_rough), _BASE_PPO, 24, 4096,
                       "rough_cassie"),
    "go1_flat_lstm": TaskSpec(
        _legged_env(lc.go1_flat), _BASE_PPO, 24, 4096, "flat_go1_lstm",
        policy_class_name="ActorCriticRecurrent"),
}


def make_env(task: str, num_envs=None, seed: int = 1, device="cuda"):
    """(env, spec) for a registered task, built on `device` (`cuda`
    unless the caller asks for the CPU)."""
    spec = TASKS[task]
    return spec.make_env(num_envs or spec.default_num_envs, seed, device), spec


def make_runner(task: str, num_envs=None, seed: int = 1, log_dir=None,
                device="cuda", ppo_overrides=None, env_setup=None):
    """(env, runner, spec). `env_setup(env)` sets env flags
    (spawn_relative, droop compensation, ...) before the runner's initial
    reset; `ppo_overrides` replaces fields of the task's PPOConfig.

    Inside a process group the run is data-parallel: num_envs is the
    job's count, and this rank builds its N // world envs from the same
    cfg and seed (the same terrain on every rank); `env` is that shard."""
    from ..parallel import distributed as dist
    num_envs = dist.host_env_count(num_envs or TASKS[task].default_num_envs)
    with spans.span("setup.env"):
        env, spec = make_env(task, num_envs, seed, device)
        if env_setup is not None:
            env_setup(env)
    if ppo_overrides:
        spec = spec._replace(
            ppo_cfg=dataclasses.replace(spec.ppo_cfg, **ppo_overrides))
    with spans.span("setup.runner"):
        if spec.policy_class_name == "ActorCriticRecurrent":
            from ..rl.recurrent import RecurrentRunner
            runner = RecurrentRunner(
                env, spec.ppo_cfg, num_steps_per_env=spec.num_steps_per_env,
                seed=seed, log_dir=log_dir)
        else:
            from ..rl.runner import OnPolicyRunner
            runner = OnPolicyRunner(
                env, spec.ppo_cfg, num_steps_per_env=spec.num_steps_per_env,
                log_dir=log_dir, seed=seed)
    return env, runner, spec
