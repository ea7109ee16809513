"""The recurrent actor-critic of legged_gym's rsl_rl
(rsl_rl/modules/actor_critic_recurrent.py) in plain float32 torch: an LSTM
memory in front of each of the actor's and the critic's MLPs, its hidden
state reset where an episode ended.

Written for the benchmark from rsl_rl's description, not copied from the
program; only `_mlp` and the activations are the reference's
own (models/actor_critic.py). Departures from rsl_rl, each on purpose:
  * the LSTM is written out gate by gate (i, f, g, o; c' = s(f) c +
    s(i) tanh(g), h' = s(o) tanh(c')), with no nn.LSTM and no cuDNN, so
    that the matmul precision switch (reference.precision) governs it;
  * one bias, on the hidden side, where nn.LSTM has bias_ih and bias_hh:
    the cell only ever sees their sum;
  * one layer (the configuration's rnn_num_layers 1);
  * the weights are the benchmark's (benchmark/weights.py), loaded by
    name, in place of the class's initialiser, so the parameters carry
    the program's names: memory_a / memory_c .wi (input side, no bias)
    and .wh (hidden side), actor_layers, critic_layers, std.
A carry is ((c, h) of the actor's memory, (c, h) of the critic's).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .actor_critic import _ACT, _mlp


class LSTMMemory(nn.Module):
    def __init__(self, num_in: int, hidden: int):
        super().__init__()
        self.wi = nn.Linear(num_in, 4 * hidden, bias=False)
        self.wh = nn.Linear(hidden, 4 * hidden)

    def cell(self, carry, x):
        """One step: ((c, h), x (B, in)) -> (c', h')."""
        c, h = carry
        z = F.linear(x, self.wi.weight) + F.linear(h, self.wh.weight,
                                                    self.wh.bias)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return c, h

    def sequence(self, carry, xs):
        """The cell over (T, B, in) from `carry` with no reset inside:
        the outputs h (T, B, H)."""
        out = []
        for x in xs:
            carry = self.cell(carry, x)
            out.append(carry[1])
        return torch.stack(out)


def reset(carry, dones):
    """The carry with the rows of ended episodes set to zero (rsl_rl's
    Memory.reset)."""
    if torch.is_tensor(carry):
        return torch.where(dones[:, None], 0.0, carry)
    return tuple(reset(c, dones) for c in carry)


class ActorCriticRecurrent(nn.Module):
    def __init__(self, num_obs: int, num_actions: int, rnn_hidden_size: int,
                 actor_hidden_dims: Sequence[int],
                 critic_hidden_dims: Sequence[int], activation: str = "elu",
                 init_noise_std: float = 1.0):
        super().__init__()
        self.rnn_type = "lstm"
        self.rnn_num_layers = 1
        self.rnn_hidden_size = rnn_hidden_size
        self.act = _ACT[activation]
        self.memory_a = LSTMMemory(num_obs, rnn_hidden_size)
        self.memory_c = LSTMMemory(num_obs, rnn_hidden_size)
        self.actor_layers = _mlp(rnn_hidden_size,
                                 tuple(actor_hidden_dims) + (num_actions,))
        self.critic_layers = _mlp(rnn_hidden_size,
                                  tuple(critic_hidden_dims) + (1,))
        self.std = nn.Parameter(torch.full((num_actions,),
                                           float(init_noise_std)))

    def initial_state(self, batch: int):
        z = torch.zeros((batch, self.rnn_hidden_size), device=self.std.device)
        return ((z, z), (z, z))

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return layers[-1](x)

    def actor(self, h):
        return self._head(self.actor_layers, h)

    def critic(self, h):
        return self._head(self.critic_layers, h)

    def step(self, carry, obs):
        """One step of both memories from `carry` (already reset where an
        episode ended): (carry', action mean, value)."""
        ca = self.memory_a.cell(carry[0], obs)
        cc = self.memory_c.cell(carry[1], obs)
        return (ca, cc), self.actor(ca[1]), self.critic(cc[1])
