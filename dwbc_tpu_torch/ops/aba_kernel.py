"""The fused substep's articulated-body algorithm as one hand-written CUDA
kernel for Hopper.

`aba` is a drop-in for `sim.aba.fused_aba` (same signature, same returns):

  * on CPU tensors it runs that plain PyTorch version;
  * on CUDA tensors it launches csrc/aba.cu, built at first use with nvcc
    into dwbc_tpu_torch/build/ (rebuilt when the source is newer than the
    library) and bound with ctypes. A failed build or launch raises;
    nothing falls back to the plain version. The kernel takes at most
    NB_MAX bodies and indexes its arrays with 32-bit offsets
    (`check_limits`, before the launch).

`aba.launches` counts kernel launches (plain-version calls do not count),
and each launch adds one to the span module's counter `aba_kernel`, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..sim.aba import TABLE_W, TreeConst, fused_aba
from ..utils import spans
from . import nvcc

SOURCE = os.path.join(nvcc.CSRC, "aba.cu")
LIBRARY = os.path.join(nvcc.BUILD, "libaba.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
# the kernel's limit (NB_MAX in csrc/aba.cu)
NB_MAX = 32

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile csrc/aba.cu into LIBRARY if it is missing, older than its
    source, or `force`; returns nvcc's output (ptxas register and spill
    report) or "" when the library was up to date."""
    return nvcc.build(SOURCE, LIBRARY, NVCC_FLAGS, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load(SOURCE, LIBRARY, NVCC_FLAGS)
        fn = lib.dwbc_aba
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def check_limits(nb: int, n: int) -> None:
    """Raise ValueError unless 1 <= nb <= NB_MAX and the (N, nb, 6, 6)
    spatial inertias fit 32-bit offsets."""
    if not 1 <= nb <= NB_MAX:
        raise ValueError(f"aba kernel: {nb} bodies, supports 1..{NB_MAX}")
    if not 1 <= n or 36 * nb * n >= 2 ** 32:
        raise ValueError(f"aba kernel: {n} envs x {nb} bodies, needs "
                         f"1 <= envs and 36 x bodies x envs < 2^32")


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _launch(tc: TreeConst, q, qd, tau, R_stack, v_stack, IA_body, mass, com,
            bF, bN):
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
        _check(name, t, shape, dev)
    ins = [t.contiguous() for _, t, _ in args]
    qdd = torch.empty((n, nj), dtype=torch.float32, device=dev)
    base_acc = torch.empty((n, 6), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dwbc_aba(*(t.data_ptr() for t in ins), qdd.data_ptr(),
                           base_acc.data_ptr(), nb, n, tc.limit_kp,
                           tc.limit_kd, tc.dt, *tc.gravity, stream)
    if err != 0:
        raise RuntimeError(f"aba kernel launch failed: cudaError {err}")
    aba.launches += 1
    spans.count("aba_kernel")
    return qdd, base_acc[:, :3], base_acc[:, 3:]


def aba(tc: TreeConst, q, qd, tau, R_stack, v_stack, IA_body, mass, com,
        bF, bN):
    """Drop-in for `sim.aba.fused_aba`: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return fused_aba(tc, q, qd, tau, R_stack, v_stack, IA_body, mass,
                         com, bF, bN)
    if q.device.type == "cuda":
        return _launch(tc, q, qd, tau, R_stack, v_stack, IA_body, mass, com,
                       bF, bN)
    raise ValueError(f"aba: unsupported device {q.device}")


aba.launches = 0
