"""The fused substep's forward kinematics as one hand-written CUDA kernel
for Hopper.

`fk` is a drop-in for `sim.fk.fused_fk` (same signature, same returns):

  * on CPU tensors it runs that plain PyTorch version;
  * on CUDA tensors it launches csrc/fk.cu, built at first use with nvcc
    into dwbc_tpu_torch/build/ (rebuilt when the source is newer than the
    library) and bound with ctypes. A failed build or launch raises;
    nothing falls back to the plain version. The kernel takes at most
    NB_MAX bodies and indexes its arrays with 32-bit offsets
    (`check_limits`, before the launch).

`fk.launches` counts kernel launches (plain-version calls do not count),
and each launch adds one to the span module's counter `fk_kernel`, so a
run can show that its main path went through the kernel. Both are bumped
in one place: the span module keeps counts only inside a training
iteration, and chip_smoke.py's phases also count launches outside one.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..sim.aba import TABLE_W, TreeConst
from ..sim.fk import fused_fk
from ..utils import spans
from . import nvcc
from .aba_kernel import _check

SOURCE = os.path.join(nvcc.CSRC, "fk.cu")
LIBRARY = os.path.join(nvcc.BUILD, "libfk.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
# the kernel's limit (NB_MAX in csrc/fk.cu)
NB_MAX = 32

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile csrc/fk.cu into LIBRARY if it is missing, older than its
    source, or `force`; returns nvcc's output (ptxas register and spill
    report) or "" when the library was up to date."""
    return nvcc.build(SOURCE, LIBRARY, NVCC_FLAGS, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load(SOURCE, LIBRARY, NVCC_FLAGS)
        fn = lib.dwbc_fk
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        _lib = lib
    return _lib


def check_limits(nb: int, n: int) -> None:
    """Raise ValueError unless 1 <= nb <= NB_MAX and the (nb, N, 3, 3)
    rotations fit 32-bit offsets."""
    if not 1 <= nb <= NB_MAX:
        raise ValueError(f"fk kernel: {nb} bodies, supports 1..{NB_MAX}")
    if not 1 <= n or 9 * nb * n >= 2 ** 32:
        raise ValueError(f"fk kernel: {n} envs x {nb} bodies, needs "
                         f"1 <= envs and 9 x bodies x envs < 2^32")


def _launch(tc: TreeConst, q, qd):
    nb, n = tc.nb, q.shape[0]
    check_limits(nb, n)
    dev = q.device
    _check("q", q, (n, nb + 6), dev)
    _check("table", tc.table, (nb, TABLE_W), dev)
    if qd is not None:
        _check("qd", qd, (n, nb + 5), dev)
        qd = qd.contiguous()
    q, table = q.contiguous(), tc.table.contiguous()
    R = torch.empty((nb, n, 3, 3), dtype=torch.float32, device=dev)
    p = torch.empty((nb, n, 3), dtype=torch.float32, device=dev)
    v = (None if qd is None
         else torch.empty((nb, n, 6), dtype=torch.float32, device=dev))
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dwbc_fk(q.data_ptr(), None if qd is None else qd.data_ptr(),
                          table.data_ptr(), R.data_ptr(), p.data_ptr(),
                          None if v is None else v.data_ptr(), nb, n, stream)
    if err != 0:
        raise RuntimeError(f"fk kernel launch failed: cudaError {err}")
    fk.launches += 1
    spans.count("fk_kernel")
    return R, p, v


def fk(tc: TreeConst, q, qd=None):
    """Drop-in for `sim.fk.fused_fk`: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors. Returns (R (nb, N, 3, 3),
    p (nb, N, 3), v (nb, N, 6) or None without qd)."""
    if q.device.type == "cpu":
        return fused_fk(tc, q, qd)
    if q.device.type == "cuda":
        return _launch(tc, q, qd)
    raise ValueError(f"fk: unsupported device {q.device}")


fk.launches = 0
