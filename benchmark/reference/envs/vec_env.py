"""Vectorized-env contract (reference rsl_rl/env/vec_env.py:36-60).

Counterpart of dwbc_tpu/envs/vec_env.py: an env is static metadata plus
step/reset over an explicit state object. `rl.runner.Rollout` drives
anything satisfying this protocol; `isinstance(env, VecEnv)` checks it.
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class VecEnv(Protocol):
    """Static metadata + step/reset.

    Required attributes:
      num_envs: int           -- batch size N
      num_obs: int            -- observation width
      num_actions: int        -- action width
      max_episode_length: int -- steps per episode
      device: torch.device    -- where the state lives
      reward_names: list[str] -- active reward terms (episode stat keys)

    Dual-reward envs additionally expose `arm_reward_names` and
    `metric_names`, and their StepOut carries `arm_rew` and `extras` (the
    OSC supervision data, possibly empty).

    A single-reward env (the legged-robot family) has no
    `arm_reward_names`; `metric_names` is optional. Its step output has
    no `arm_rew` and no `extras`; its episode_stats hold `rew_<name>` for
    every reward name, `metric_<name>` for every metric name, `reward_sum`,
    `len_sum` and `terrain_level` (the mean curriculum level of this
    step, logged as a per-step mean).

    step() returns (new_state, out) where `out` has fields
    obs / rew / reset / time_outs / episode_stats / num_resets; envs whose
    curricula follow the learn-iteration counter take it as a third
    argument (widowGo1.py:678-692).
    """

    num_envs: int
    num_obs: int
    num_actions: int
    max_episode_length: int
    device: torch.device

    def reset(self, gen: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """Build the full env-batch state; returns (state, obs)."""
        ...

    def step(self, state: Any, actions: torch.Tensor, *counter
             ) -> Tuple[Any, Any]:
        """Transition; returns (new_state, StepOut-like)."""
        ...
