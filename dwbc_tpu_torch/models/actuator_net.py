"""ANYdrive v3 actuator network on torch tensors.

Counterpart of dwbc_tpu/models/actuator_net.py (the reference's
TorchScript LSTM, anymal.py:52-78, resources/actuator_nets/
anydrive_v3_lstm.pt): a per-joint 2-layer LSTM (input [pos_err, vel],
hidden 8) + linear torque head, evaluated every physics substep with
per-(env, joint) hidden state. The weights ship vendored as .npz under
the PyTorch LSTM's parameter names; the cell is written out with plain
matmuls (gate order i, f, g, o; one bias b = b_ih + b_hh), as the JAX
module computes it.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.urdf import ASSETS_ROOT
from ..utils.device import resolve_device

DEFAULT_NPZ = os.path.join(ASSETS_ROOT,
                           "actuator_nets/anydrive_v3_lstm.npz")

HIDDEN = 8
LAYERS = 2


class ActuatorNetParams(NamedTuple):
    w_ih: Tuple[torch.Tensor, ...]  # per layer (4H, in)
    w_hh: Tuple[torch.Tensor, ...]  # per layer (4H, H)
    b: Tuple[torch.Tensor, ...]     # per layer (4H,) = b_ih + b_hh
    w_out: torch.Tensor             # (1, H)
    b_out: torch.Tensor             # (1,)


def load_params(path: str = DEFAULT_NPZ, device="cuda") -> ActuatorNetParams:
    dev = resolve_device(device)
    p = dict(np.load(path))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return ActuatorNetParams(
        w_ih=tuple(t(p[f"lstm.weight_ih_l{i}"]) for i in range(LAYERS)),
        w_hh=tuple(t(p[f"lstm.weight_hh_l{i}"]) for i in range(LAYERS)),
        b=tuple(t(p[f"lstm.bias_ih_l{i}"] + p[f"lstm.bias_hh_l{i}"])
                for i in range(LAYERS)),
        w_out=t(p["linear.weight"]),
        b_out=t(p["linear.bias"]),
    )


def init_hidden(batch: int, device="cuda") -> torch.Tensor:
    """(layers, 2, batch, H) — h and c stacked."""
    return torch.zeros((LAYERS, 2, batch, HIDDEN),
                       device=resolve_device(device))


def step(params: ActuatorNetParams, x: torch.Tensor, hidden: torch.Tensor):
    """x: (B, 2) [pos_err, vel]; hidden: (layers, 2, B, H).
    Returns (torque (B,), new_hidden)."""
    inp = x
    new_hidden = []
    for l in range(LAYERS):
        h, c = hidden[l, 0], hidden[l, 1]
        gates = inp @ params.w_ih[l].T + h @ params.w_hh[l].T + params.b[l]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        new_hidden.append(torch.stack([h, c]))
        inp = h
    tau = inp @ params.w_out.T + params.b_out
    return tau[..., 0], torch.stack(new_hidden)
