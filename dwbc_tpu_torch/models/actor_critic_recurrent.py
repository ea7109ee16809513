"""Recurrent ActorCritic variant (LSTM/GRU memory before the MLP).

Counterpart of dwbc_tpu/models/actor_critic_recurrent.py (the reference
ActorCriticRecurrent, actor_critic_recurrent.py:40-116): a recurrent
memory encodes observations before the actor and critic MLPs; the hidden
state is reset where episodes end. The hidden state is an explicit carry,
not module state; for BPTT use `unroll` over a (T, B, obs) trajectory
with a done mask.

The cells are written from `nn.Linear` in the layout of the flax cells the
JAX model uses, so that interop.recurrent_from_flax is a plain copy:
  * LSTM (flax OptimizedLSTMCell): gates i, f, g, o; the input side has no
    bias, the hidden side has one; the carry is (c, h);
  * GRU (flax GRUCell): r, z, n; the input side carries the bias of all
    three, the hidden side has none for r and z and its own for n, inside
    r * (W_hn h + b_hn); the carry is h.
A fresh model is initialised as flax initialises the cells and the MLPs:
lecun_normal input and MLP kernels (`actor_critic.flax_init_`), an
orthogonal recurrent kernel per gate, zero biases.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import lstm_kernel
from .actor_critic import _ACT, _mlp, flax_init_


@torch.no_grad()
def _orthogonal_gates_(layer: nn.Linear, gates: int):
    """Each gate's (hidden, hidden) block of a recurrent kernel drawn
    orthogonal, as flax's cells draw one recurrent kernel per gate."""
    for block in layer.weight.chunk(gates, 0):
        nn.init.orthogonal_(block)


class LSTMCell(nn.Module):
    def __init__(self, num_in: int, hidden: int):
        super().__init__()
        self.wi = nn.Linear(num_in, 4 * hidden, bias=False)
        self.wh = nn.Linear(hidden, 4 * hidden)

    def init_recurrent_(self):
        _orthogonal_gates_(self.wh, 4)

    def forward(self, carry, x):
        c, h = carry
        i, f, g, o = torch.chunk(self.wi(x) + self.wh(h), 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class GRUCell(nn.Module):
    def __init__(self, num_in: int, hidden: int):
        super().__init__()
        self.wi = nn.Linear(num_in, 3 * hidden)
        self.wh = nn.Linear(hidden, 2 * hidden, bias=False)
        self.whn = nn.Linear(hidden, hidden)

    def init_recurrent_(self):
        _orthogonal_gates_(self.wh, 2)
        _orthogonal_gates_(self.whn, 1)

    def forward(self, h, x):
        ir, iz, i_n = torch.chunk(self.wi(x), 3, dim=-1)
        hr, hz = torch.chunk(self.wh(h), 2, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * self.whn(h))
        h = (1.0 - z) * n + z * h
        return h, h


def _map_carry(fn, carry):
    """fn over every tensor of a (nested tuple) carry."""
    if torch.is_tensor(carry):
        return fn(carry)
    return tuple(_map_carry(fn, c) for c in carry)


@dataclasses.dataclass(frozen=True)
class RecurrentPolicyCfg:
    """The recurrent policy's widths, named as ActorCriticRecurrent's
    arguments (the reference's LeggedRobotCfgPPO.policy and its block for
    'ActorCriticRecurrent', legged_robot_config.py). The defaults are the
    JAX package's RecurrentRunner's: an LSTM of 64 and one layer of 64 in
    each head. Only the widths differ between the two in use; rnn_type,
    activation and init_noise_std mirror the reference's block and hold
    one value in both."""

    rnn_type: str = "lstm"
    rnn_hidden_size: int = 64
    actor_hidden_dims: Tuple[int, ...] = (64,)
    critic_hidden_dims: Tuple[int, ...] = (64,)
    activation: str = "elu"
    init_noise_std: float = 1.0


class ActorCriticRecurrent(nn.Module):
    """obs -> RNN -> actor/critic MLP heads (single-head action space)."""

    def __init__(self, num_obs: int = 48, num_actions: int = 12,
                 rnn_hidden_size: int = 256, rnn_type: str = "lstm",
                 actor_hidden_dims: Sequence[int] = (256, 256),
                 critic_hidden_dims: Sequence[int] = (256, 256),
                 activation: str = "elu", init_noise_std: float = 1.0):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError("rnn_type must be 'lstm' or 'gru'")
        self.rnn_type = rnn_type
        self.rnn_hidden_size = rnn_hidden_size
        self.act = _ACT[activation]
        cell = LSTMCell if rnn_type == "lstm" else GRUCell
        self.memory_a = cell(num_obs, rnn_hidden_size)
        self.memory_c = cell(num_obs, rnn_hidden_size)
        self.actor_layers = _mlp(rnn_hidden_size,
                                 tuple(actor_hidden_dims) + (num_actions,))
        self.critic_layers = _mlp(rnn_hidden_size,
                                  tuple(critic_hidden_dims) + (1,))
        self.std = nn.Parameter(torch.full((num_actions,),
                                           float(init_noise_std)))
        flax_init_(self)
        self.memory_a.init_recurrent_()
        self.memory_c.init_recurrent_()

    def initial_state(self, batch: int):
        """Zero carry on the parameters' device: ((c, h), (c, h)) for the
        actor's and the critic's LSTM, (h, h) for the GRUs."""
        z = torch.zeros((batch, self.rnn_hidden_size), device=self.std.device)
        if self.rnn_type == "lstm":
            return ((z, z), (z, z))
        return (z, z)

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return layers[-1](x)

    def step(self, carry, obs, dones=None):
        """One timestep: (carry, obs (B, D)) -> (carry, actions_mean,
        value). dones (B,) resets the hidden state first (reference
        actor_critic_recurrent `reset`)."""
        ca, cc = carry
        if dones is not None:
            keep = 1.0 - dones.to(torch.float32)[:, None]
            ca = _map_carry(lambda h: h * keep, ca)
            cc = _map_carry(lambda h: h * keep, cc)
        ca, ya = self.memory_a(ca, obs)
        cc, yc = self.memory_c(cc, obs)
        return ((ca, cc), self._head(self.actor_layers, ya),
                self._head(self.critic_layers, yc))

    def forward(self, obs):
        """A single step from the zero state: (mean, std, value)."""
        _, mean, value = self.step(self.initial_state(obs.shape[0]), obs)
        return mean, self.std, value

    def unroll(self, carry, obs_seq, dones_seq):
        """BPTT over (T, B, D) with per-step done resets — the masked-loop
        equivalent of split_and_pad_trajectories (utils/utils.py:33-71).
        Returns (carry, (means (T, B, A), values (T, B, 1))), what `step`
        gives step by step. The LSTM runs as one sequence op
        (ops/lstm_kernel.py): both memories' input projections once over
        all T x B rows, the recurrence a step at a time, then both heads
        once over all rows. The GRU keeps the loop of steps."""
        if self.rnn_type != "lstm":
            means, values = [], []
            for obs, dones in zip(obs_seq, dones_seq):
                carry, mean, value = self.step(carry, obs, dones)
                means.append(mean)
                values.append(value)
            return carry, (torch.stack(means), torch.stack(values))
        T, B, _ = obs_seq.shape
        mems = (self.memory_a, self.memory_c)
        wi = torch.stack([m.wi.weight for m in mems])
        wh = torch.stack([m.wh.weight for m in mems])
        bias = torch.stack([m.wh.bias for m in mems])
        x = obs_seq.reshape(1, T * B, -1).expand(len(mems), -1, -1)
        xproj = torch.baddbmm(bias[:, None], x, wi.transpose(1, 2))
        keep = 1.0 - dones_seq.to(wh.dtype)
        (ca, ha), (cc, hc) = carry
        c0 = torch.stack([ca, cc]) * keep[0][:, None]
        h0 = torch.stack([ha, hc]) * keep[0][:, None]
        y, c = lstm_kernel.lstm_sequence(
            xproj.view(len(mems), T, B, -1), c0, h0, wh, keep)
        rows = y.view(len(mems), T * B, -1)
        means = self._head(self.actor_layers, rows[0]).view(T, B, -1)
        values = self._head(self.critic_layers, rows[1]).view(T, B, -1)
        return ((c[0], y[0, -1]), (c[1], y[1, -1])), (means, values)
