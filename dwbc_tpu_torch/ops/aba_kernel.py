"""The fused substep's articulated-body algorithm as one hand-written CUDA
kernel for Hopper.

`aba` is a drop-in for `sim.aba.fused_aba` (same signature, same returns):
on CPU tensors it runs that plain PyTorch version, on CUDA tensors it
launches csrc/aba.cu (ops/kernel.py: build, load, launch, and the launch
counter `aba_kernel`). The kernel takes at most NB_MAX bodies and indexes
its arrays with 32-bit offsets (`check_limits`, before the launch).
"""

from __future__ import annotations

import ctypes

import torch

from ..sim.aba import fused_aba
from ..sim.tree import TABLE_W, TreeConst
from . import kernel

KERNEL = kernel.Kernel(
    "aba_kernel", "aba.cu", "dwbc_aba",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6)
build = KERNEL.build
# the kernel's limit (NB_MAX in csrc/aba.cu)
NB_MAX = 32


def check_limits(nb: int, n: int) -> None:
    """Raise ValueError unless 1 <= nb <= NB_MAX and the (N, nb, 6, 6)
    spatial inertias fit 32-bit offsets."""
    if not 1 <= nb <= NB_MAX:
        raise ValueError(f"aba kernel: {nb} bodies, supports 1..{NB_MAX}")
    if not 1 <= n or 36 * nb * n >= 2 ** 32:
        raise ValueError(f"aba kernel: {n} envs x {nb} bodies, needs "
                         f"1 <= envs and 36 x bodies x envs < 2^32")


def aba(tc: TreeConst, q, qd, tau, R_stack, v_stack, IA_body, mass, com,
        bF, bN):
    """Drop-in for `sim.aba.fused_aba`: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if not KERNEL.takes(q):
        return fused_aba(tc, q, qd, tau, R_stack, v_stack, IA_body, mass,
                         com, bF, bN)
    nb, n = tc.nb, q.shape[0]
    check_limits(nb, n)
    nj, dev = nb - 1, q.device
    args = (("q", q, (n, nb + 6)), ("qd", qd, (n, nb + 5)),
            ("tau", tau, (n, nj)), ("R_stack", R_stack, (nb, n, 3, 3)),
            ("v_stack", v_stack, (nb, n, 6)),
            ("IA_body", IA_body, (n, nb, 6, 6)), ("mass", mass, (n, nb)),
            ("com", com, (n, nb, 3)), ("bF", bF, (3, nb, n)),
            ("bN", bN, (3, nb, n)), ("table", tc.table, (nb, TABLE_W)))
    for name, t, shape in args:
        kernel.check(name, t, shape, dev)
    ins = [t.contiguous() for _, t, _ in args]
    qdd = torch.empty((n, nj), dtype=torch.float32, device=dev)
    base_acc = torch.empty((n, 6), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, *(t.data_ptr() for t in ins), qdd.data_ptr(),
                  base_acc.data_ptr(), nb, n, tc.limit_kp, tc.limit_kd,
                  tc.dt, *tc.gravity)
    return qdd, base_acc[:, :3], base_acc[:, 3:]
