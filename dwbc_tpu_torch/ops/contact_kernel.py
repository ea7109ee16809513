"""The contact law as a hand-written CUDA kernel for Hopper.

Counterpart of dwbc_tpu/ops/contact_pallas.py. `contact_law` is a drop-in
for `sim.contact.fused_terrain_law` (same signature, same returns):

  * on CPU tensors it runs that plain PyTorch version;
  * on CUDA tensors it launches csrc/contact_law.cu, built at first use
    with nvcc into dwbc_tpu_torch/build/ (rebuilt when the source is newer
    than the library) and bound with ctypes. A failed build or launch
    raises; nothing falls back to the plain version. The kernel takes at
    most NG_MAX spheres and NB_MAX bodies, and indexes its planes with
    32-bit offsets (`check_limits`, before the launch).

`contact_law.launches` counts kernel launches (plain-version calls do not
count), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from ..sim.contact import ContactParams, GeomConst, fused_terrain_law
from ..utils import spans

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "contact_law.cu")
LIBRARY = os.path.join(_PKG, "build", "libcontact_law.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# the kernel's limits (NG_MAX, NB_MAX in csrc/contact_law.cu)
NG_MAX = 128
NB_MAX = 32

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the contact "
                           "kernel")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/contact_law.cu into LIBRARY if it is missing, older
    than its source, or `force`; returns nvcc's output (ptxas register and
    spill report) or "" when the library was up to date."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return ""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with spans.span("setup.native"):
            build()
            lib = ctypes.CDLL(LIBRARY)
        fn = lib.dwbc_contact_law
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def check_limits(ng: int, nb: int, n: int) -> None:
    """Raise ValueError unless 1 <= ng <= NG_MAX, 1 <= nb <= NB_MAX and
    the (3, ng, n) planes fit 32-bit offsets."""
    if not 1 <= ng <= NG_MAX:
        raise ValueError(f"contact kernel: {ng} spheres, supports 1..{NG_MAX}")
    if not 1 <= nb <= NB_MAX:
        raise ValueError(f"contact kernel: {nb} bodies, supports 1..{NB_MAX}")
    if not 1 <= n or 3 * ng * n >= 2 ** 32:
        raise ValueError(f"contact kernel: {n} envs x {ng} spheres, needs "
                         f"1 <= envs and 3 x spheres x envs < 2^32")


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(gp, gv, terrain_cache, fprev, friction, gc: GeomConst,
            cp: ContactParams, dt: float):
    h_a, nrm, ax, ay = terrain_cache
    ng, n = h_a.shape[-2], gp.shape[-1]
    check_limits(ng, gc.nb, n)
    dev = gp.device
    f32 = torch.float32
    for name, t in (("gp", gp), ("gv", gv), ("fprev", fprev), ("nrm", nrm)):
        _check(name, t, (3, ng, n), f32, dev)
    for name, t in (("h_a", h_a), ("ax", ax), ("ay", ay)):
        _check(name, t, (ng, n), f32, dev)
    _check("friction", friction, (n,), f32, dev)
    for name, t in (("radius", gc.radius), ("m_solo", gc.m_solo),
                    ("m_body", gc.m_body)):
        _check(name, t, (ng,), f32, dev)
    _check("w6", gc.w6, (6, ng), f32, dev)
    _check("geom_body", gc.geom_body, (ng,), torch.int32, dev)

    gF = torch.empty((3, ng, n), dtype=f32, device=dev)
    cf = torch.empty((3, ng, n), dtype=f32, device=dev)
    share_f = torch.empty((ng, n), dtype=f32, device=dev)
    active = torch.empty((ng, n), dtype=torch.bool, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dwbc_contact_law(
            gp.data_ptr(), gv.data_ptr(), fprev.data_ptr(), nrm.data_ptr(),
            h_a.data_ptr(), ax.data_ptr(), ay.data_ptr(), friction.data_ptr(),
            gc.radius.data_ptr(), gc.m_solo.data_ptr(), gc.m_body.data_ptr(),
            gc.w6.data_ptr(), gc.geom_body.data_ptr(), gF.data_ptr(),
            cf.data_ptr(), share_f.data_ptr(), active.data_ptr(),
            ng, gc.nb, n, cp.baumgarte, cp.max_depen_vel,
            cp.warm_growth * 9.81, cp.warm_decay, cp.relax, cp.slop,
            cp.fn_max, dt, stream)
    if err != 0:
        raise RuntimeError(f"contact_law kernel launch failed: cudaError {err}")
    contact_law.launches += 1
    return gF, cf, active, share_f


def contact_law(gp, gv, terrain_cache, fprev, friction, gc: GeomConst,
                cp: ContactParams, dt: float):
    """Drop-in for `sim.contact.fused_terrain_law`: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if gp.device.type == "cpu":
        return fused_terrain_law(gp, gv, terrain_cache, fprev, friction, gc,
                                 cp, dt)
    if gp.device.type == "cuda":
        return _launch(gp, gv, terrain_cache, fprev, friction, gc, cp, dt)
    raise ValueError(f"contact_law: unsupported device {gp.device}")


contact_law.launches = 0
