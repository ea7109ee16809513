"""Policy weights made by the benchmark from the seed, on the device.

Both the program and the reference are handed the same tensors, so the
reference takes no weights that the program made. Matrices are drawn
from one normal tensor in a single call on the device and scaled to the
variance 1 / fan_in (lecun normal, as the program's own initialiser
draws them, untruncated); biases start at zero and the policy's std at
the configuration's `policy_init_std`.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# keeps the weights' stream apart from the program's streams of one seed
_SALT = 0x5EED_BE4C


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], init_std, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the (name, shape) leaves of a policy."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ _SALT) % 2 ** 63)
    mats = [s for _, s in shapes if len(s) >= 2]
    total = sum(torch.Size(s).numel() for s in mats)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = torch.Size(shape).numel()
        if len(shape) >= 2:
            fan_in = n // shape[0]
            out[name] = flat[off:off + n].view(shape) * fan_in ** -0.5
            off += n
        elif name.split(".")[-1] == "std":
            out[name] = torch.tensor(init_std, dtype=torch.float32,
                                     device=device).reshape(shape)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters in place (an optimizer
    built over them keeps its references); names and shapes must match."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(weights):
        raise ValueError("policy leaves differ from the weights': "
                         f"{sorted(set(params) ^ set(weights))}")
    for name, p in params.items():
        p.copy_(weights[name])
