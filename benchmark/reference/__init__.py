"""The plain reference: a frozen copy of dwbc_tpu_torch's plain path
(robot model, terrain, fused physics substep with the plain contact law,
the widowGo1 and legged-robot envs, the policies, PPO and the runner), as
it stood when the benchmark was added, cut to what the cells drive: one
process, the widowGo1 and go1 tasks, PD control.

It imports nothing of the program and takes nothing the program made: it
rebuilds the robot models from the URDFs, the terrain from the seed (the
Perlin heights in Python, `native.py`) and the contact constants itself,
and is handed only the benchmark's own weights. Where the program runs
its CUDA contact kernel, the copy runs the plain law (sim/contact.py).
Its modules keep the program's layout and names; only the imports of the
kernel, of the native terrain library and the TF32 switch differ.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def precision(name: str):
    """float32 matmuls and convolutions (the configurations' precision),
    or TF32 on both: the nearest precision below, which the control of
    `correct` runs."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}; known: {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
