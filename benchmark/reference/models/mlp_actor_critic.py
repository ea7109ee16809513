"""Single-head MLP ActorCritic for the generic locomotion tasks.

Counterpart of dwbc_tpu/models/mlp_actor_critic.py: the reference's
pre-whole-body network shape (legged_robot_config.py:204-208:
actor/critic hidden [512, 256, 128], scalar init noise std, single value
head). It has the method surface of the dual-head ActorCritic (act_mean /
evaluate / priv_latent / hist_latent / std), so the rollout and PPO code
is shared; the latent methods return zeros (no ROA on this family).
interop.mlp_actor_critic_from_flax loads a flax parameter tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .actor_critic import _ACT, _mlp, flax_init_


class MlpActorCritic(nn.Module):
    def __init__(self, num_obs: int = 48, num_actions: int = 12,
                 actor_hidden_dims: Sequence[int] = (512, 256, 128),
                 critic_hidden_dims: Sequence[int] = (512, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0):
        super().__init__()
        self.act = _ACT[activation]
        self.actor_layers = _mlp(num_obs,
                                 tuple(actor_hidden_dims) + (num_actions,))
        self.critic_layers = _mlp(num_obs, tuple(critic_hidden_dims) + (1,))
        self.std = nn.Parameter(torch.full((num_actions,),
                                           float(init_noise_std)))
        flax_init_(self)

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return layers[-1](x)

    def act_mean(self, obs, hist_encoding: bool = False):
        return self._head(self.actor_layers, obs)

    def evaluate(self, obs):
        return self._head(self.critic_layers, obs)

    def priv_latent(self, obs):
        return obs.new_zeros(obs.shape[:-1] + (1,))

    def hist_latent(self, obs):
        return obs.new_zeros(obs.shape[:-1] + (1,))

    def forward(self, obs, hist_encoding: bool = False):
        """(action mean, std, value)."""
        return self.act_mean(obs), self.std, self.evaluate(obs)
