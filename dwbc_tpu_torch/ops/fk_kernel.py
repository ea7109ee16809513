"""The fused substep's forward kinematics as one hand-written CUDA kernel
for Hopper.

`fk` is a drop-in for `sim.fk.fused_fk` (same signature, same returns):
on CPU tensors it runs that plain PyTorch version, on CUDA tensors it
launches csrc/fk.cu (ops/kernel.py: build, load, launch, and the launch
counter `fk_kernel`). The kernel takes at most NB_MAX bodies and indexes
its arrays with 32-bit offsets (`check_limits`, before the launch).
"""

from __future__ import annotations

import ctypes

import torch

from ..sim.fk import fused_fk
from ..sim.tree import TABLE_W, TreeConst
from . import kernel

KERNEL = kernel.Kernel("fk_kernel", "fk.cu", "dwbc_fk",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2)
build = KERNEL.build
# the kernel's limit (NB_MAX in csrc/fk.cu)
NB_MAX = 32


def check_limits(nb: int, n: int) -> None:
    """Raise ValueError unless 1 <= nb <= NB_MAX and the (nb, N, 3, 3)
    rotations fit 32-bit offsets."""
    if not 1 <= nb <= NB_MAX:
        raise ValueError(f"fk kernel: {nb} bodies, supports 1..{NB_MAX}")
    if not 1 <= n or 9 * nb * n >= 2 ** 32:
        raise ValueError(f"fk kernel: {n} envs x {nb} bodies, needs "
                         f"1 <= envs and 9 x bodies x envs < 2^32")


def fk(tc: TreeConst, q, qd=None):
    """Drop-in for `sim.fk.fused_fk`: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors. Returns (R (nb, N, 3, 3),
    p (nb, N, 3), v (nb, N, 6) or None without qd)."""
    if not KERNEL.takes(q):
        return fused_fk(tc, q, qd)
    nb, n = tc.nb, q.shape[0]
    check_limits(nb, n)
    dev = q.device
    kernel.check("q", q, (n, nb + 6), dev)
    kernel.check("table", tc.table, (nb, TABLE_W), dev)
    if qd is not None:
        kernel.check("qd", qd, (n, nb + 5), dev)
        qd = qd.contiguous()
    q, table = q.contiguous(), tc.table.contiguous()
    R = torch.empty((nb, n, 3, 3), dtype=torch.float32, device=dev)
    p = torch.empty((nb, n, 3), dtype=torch.float32, device=dev)
    v = (None if qd is None
         else torch.empty((nb, n, 6), dtype=torch.float32, device=dev))
    KERNEL.launch(dev, q.data_ptr(), None if qd is None else qd.data_ptr(),
                  table.data_ptr(), R.data_ptr(), p.data_ptr(),
                  None if v is None else v.data_ptr(), nb, n)
    return R, p, v
