"""Dual-head ActorCritic with Regularized Online Adaptation encoders.

Counterpart of dwbc_tpu/models/actor_critic.py as torch `nn.Module`s,
with the flax model's layout at the public boundary: observations are
(B, 860) = [prop(76), priv(24), history(10 x 76)], actions (B, 18) =
[leg(12), arm(6)], values (B, 2) = [leg, arm].
  * StateHistoryEncoder: per-step linear projection -> 1D convs over the
    T in {10, 20, 50} step history -> linear (reference :39-84);
  * Actor: privileged-obs encoder (24->64->20) OR history encoder to the
    same 20-d latent, shared backbone, 12-d tanh leg head and 6-d tanh
    arm head (reference :119-229); with `adaptive_arm_gains` the arm head
    has 12 outputs, the last 6 (arm kp deltas) scaled by
    `adaptive_arm_gains_scale`;
  * Critic: prop+priv input, shared backbone, leg/arm value heads;
  * learnable per-joint std;
  * per-head (leg/arm) log-prob and entropy sums (reference :326-345).
interop.actor_critic_from_flax loads a flax parameter tree. A fresh model
is initialised as flax initialises the JAX one (`flax_init_`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

_ACT = {
    "elu": F.elu,
    "relu": F.relu,
    "selu": F.selu,
    "crelu": F.relu,
    "lrelu": F.leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(module: nn.Module) -> nn.Module:
    """Initialise every nn.Linear and nn.Conv1d of `module` as flax
    initialises nn.Dense and nn.Conv by default (lecun_normal): weights
    from a normal truncated at two standard deviations with variance
    1 / fan_in, biases zero. torch's own default (uniform weights with a
    third of that variance, uniform biases) starts training elsewhere
    than the JAX package does."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


# (kernel, stride) of the two or three VALID convs per history length,
# output channels (2*ch, ch[, ch]) — reference :53-69
_CONVS = {50: ((8, 4), (5, 1), (5, 1)), 20: ((6, 2), (4, 2)),
          10: ((4, 2), (2, 1))}


class StateHistoryEncoder(nn.Module):
    """(B, T, prop) -> (B, out)."""

    def __init__(self, tsteps: int, input_size: int, output_size: int,
                 activation: str = "elu", channel_size: int = 10):
        super().__init__()
        if tsteps not in _CONVS:
            raise ValueError("tsteps must be 10, 20 or 50")
        self.tsteps = tsteps
        self.act = _ACT[activation]
        ch = channel_size
        self.proj = nn.Linear(input_size, 3 * ch)
        chans = [3 * ch, 2 * ch] + [ch] * (len(_CONVS[tsteps]) - 1)
        self.convs = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], k, stride=s)
            for i, (k, s) in enumerate(_CONVS[tsteps]))
        length = tsteps
        for k, s in _CONVS[tsteps]:
            length = (length - k) // s + 1
        self.out = nn.Linear(ch * length, output_size)

    def forward(self, obs_hist: torch.Tensor) -> torch.Tensor:
        B, T, P = obs_hist.shape
        x = self.act(self.proj(obs_hist.reshape(B * T, P)))
        x = x.reshape(B, T, -1).transpose(1, 2)       # (B, C, L) for Conv1d
        for conv in self.convs:
            x = self.act(conv(x))
        # flatten in (L, C) order, as the flax model does on NLC data
        x = x.transpose(1, 2).reshape(B, -1)
        return self.act(self.out(x))


def _mlp(in_dim: int, dims: Sequence[int]) -> nn.ModuleList:
    layers = []
    for d in dims:
        layers.append(nn.Linear(in_dim, d))
        in_dim = d
    return nn.ModuleList(layers)


class Actor(nn.Module):
    def __init__(self, num_prop=76, num_priv=24, num_hist=10,
                 priv_encoder_dims=(64, 20), actor_hidden_dims=(128,),
                 leg_head_dims=(128, 128), arm_head_dims=(128, 128),
                 num_leg_actions=12, num_arm_actions=6, activation="elu",
                 adaptive_arm_gains=False, adaptive_arm_gains_scale=10.0):
        super().__init__()
        self.num_prop, self.num_priv, self.num_hist = num_prop, num_priv, num_hist
        self.num_arm_actions = num_arm_actions
        self.adaptive_arm_gains = adaptive_arm_gains
        self.adaptive_arm_gains_scale = adaptive_arm_gains_scale
        self.act = _ACT[activation]
        self.priv_encoder_layers = _mlp(num_priv, priv_encoder_dims)
        self.history_encoder = StateHistoryEncoder(
            num_hist, num_prop, priv_encoder_dims[-1], activation)
        self.backbone_layers = _mlp(num_prop + priv_encoder_dims[-1],
                                    actor_hidden_dims)
        h = actor_hidden_dims[-1]
        self.leg_layers = _mlp(h, tuple(leg_head_dims) + (num_leg_actions,))
        # with adaptive gains the arm head also emits 6 arm kp deltas
        n_arm = num_arm_actions * (2 if adaptive_arm_gains else 1)
        self.arm_layers = _mlp(h, tuple(arm_head_dims) + (n_arm,))

    def infer_priv_latent(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs[..., self.num_prop:self.num_prop + self.num_priv]
        for layer in self.priv_encoder_layers:
            x = self.act(layer(x))
        return x

    def infer_hist_latent(self, obs: torch.Tensor) -> torch.Tensor:
        hist = obs[..., -self.num_hist * self.num_prop:]
        return self.history_encoder(
            hist.reshape(hist.shape[0], self.num_hist, self.num_prop))

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return torch.tanh(layers[-1](x))

    def forward(self, obs: torch.Tensor, hist_encoding: bool = False):
        latent = (self.infer_hist_latent(obs) if hist_encoding
                  else self.infer_priv_latent(obs))
        x = torch.cat([obs[..., :self.num_prop], latent], -1)
        for layer in self.backbone_layers:
            x = self.act(layer(x))
        arm = self._head(self.arm_layers, x)
        if self.adaptive_arm_gains:
            n = self.num_arm_actions
            arm = torch.cat([arm[..., :n],
                             self.adaptive_arm_gains_scale * arm[..., n:]], -1)
        return torch.cat([self._head(self.leg_layers, x), arm], -1)


class Critic(nn.Module):
    def __init__(self, num_prop=76, num_priv=24, critic_hidden_dims=(128,),
                 leg_head_dims=(128, 128), arm_head_dims=(128, 128),
                 activation="elu"):
        super().__init__()
        self.num_in = num_prop + num_priv
        self.act = _ACT[activation]
        self.backbone_layers = _mlp(self.num_in, critic_hidden_dims)
        h = critic_hidden_dims[-1]
        self.leg_layers = _mlp(h, tuple(leg_head_dims) + (1,))
        self.arm_layers = _mlp(h, tuple(arm_head_dims) + (1,))

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return layers[-1](x)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs[..., :self.num_in]
        for layer in self.backbone_layers:
            x = self.act(layer(x))
        return torch.cat([self._head(self.leg_layers, x),
                          self._head(self.arm_layers, x)], -1)


class ActorCritic(nn.Module):
    """Actor, critic and the learnable per-joint std."""

    def __init__(self, num_prop: int = 76, num_priv: int = 24,
                 num_hist: int = 10, num_leg_actions: int = 12,
                 num_arm_actions: int = 6,
                 init_std: Tuple[float, ...] = tuple([0.8, 1.0, 1.0] * 4
                                                     + [1.0] * 6),
                 adaptive_arm_gains: bool = False,
                 adaptive_arm_gains_scale: float = 10.0,
                 activation: str = "elu",
                 actor_hidden_dims: Sequence[int] = (128,),
                 critic_hidden_dims: Sequence[int] = (128,),
                 leg_head_dims: Sequence[int] = (128, 128),
                 arm_head_dims: Sequence[int] = (128, 128),
                 priv_encoder_dims: Sequence[int] = (64, 20)):
        super().__init__()
        self.actor = Actor(num_prop, num_priv, num_hist, priv_encoder_dims,
                           actor_hidden_dims, leg_head_dims, arm_head_dims,
                           num_leg_actions, num_arm_actions, activation,
                           adaptive_arm_gains, adaptive_arm_gains_scale)
        self.critic = Critic(num_prop, num_priv, critic_hidden_dims,
                             leg_head_dims, arm_head_dims, activation)
        self.init_std = tuple(init_std)
        self.std = nn.Parameter(torch.tensor(init_std, dtype=torch.float32))
        flax_init_(self)

    def forward(self, obs, hist_encoding: bool = False):
        """(action mean, std, value)."""
        return self.act_mean(obs, hist_encoding), self.std, self.evaluate(obs)

    def act_mean(self, obs, hist_encoding: bool = False):
        return self.actor(obs, hist_encoding)

    def evaluate(self, obs):
        return self.critic(obs)

    def priv_latent(self, obs):
        return self.actor.infer_priv_latent(obs)

    def hist_latent(self, obs):
        return self.actor.infer_hist_latent(obs)


# ---------------------------------------------------------------------------
# distribution math (per-head sums, reference actor_critic.py:326-345)


def normal_sample(gen: torch.Generator, mean, std):
    return mean + std * torch.randn(mean.shape, generator=gen,
                                    device=mean.device)


def log_prob_per_head(actions, mean, std, num_leg: int = 12):
    lp = (-0.5 * torch.square((actions - mean) / std)
          - torch.log(std) - 0.5 * math.log(2 * math.pi))
    return torch.stack([lp[..., :num_leg].sum(-1), lp[..., num_leg:].sum(-1)],
                       -1)


def entropy_per_head(std, batch_shape, num_leg: int = 12):
    ent = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)
    e = torch.stack([ent[..., :num_leg].sum(-1), ent[..., num_leg:].sum(-1)],
                    -1)
    return e.expand(tuple(batch_shape) + (2,))
