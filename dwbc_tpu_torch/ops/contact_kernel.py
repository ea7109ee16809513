"""The contact law as a hand-written CUDA kernel for Hopper.

Counterpart of dwbc_tpu/ops/contact_pallas.py. `contact_law` is a drop-in
for `sim.contact.fused_terrain_law` (same signature, same returns): on CPU
tensors it runs that plain PyTorch version, on CUDA tensors it launches
csrc/contact_law.cu (ops/kernel.py: build, load, launch, and the launch
counter `contact_kernel`). The kernel takes at most NG_MAX spheres and
NB_MAX bodies, and indexes its planes with 32-bit offsets
(`check_limits`, before the launch). Unlike the other ops it copies no
input: a non-contiguous one raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..sim.contact import ContactParams, GeomConst, fused_terrain_law
from . import kernel

KERNEL = kernel.Kernel(
    "contact_kernel", "contact_law.cu", "dwbc_contact_law",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8,
    flags=("-fmad=false",))
build = KERNEL.build
# the kernel's limits (NG_MAX, NB_MAX in csrc/contact_law.cu)
NG_MAX = 128
NB_MAX = 32


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


def contact_law(gp, gv, terrain_cache, fprev, friction, gc: GeomConst,
                cp: ContactParams, dt: float):
    """Drop-in for `sim.contact.fused_terrain_law`: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if not KERNEL.takes(gp):
        return fused_terrain_law(gp, gv, terrain_cache, fprev, friction, gc,
                                 cp, dt)
    h_a, nrm, ax, ay = terrain_cache
    ng, n = h_a.shape[-2], gp.shape[-1]
    check_limits(ng, gc.nb, n)
    dev = gp.device
    f32 = torch.float32
    args = (("gp", gp, (3, ng, n), f32), ("gv", gv, (3, ng, n), f32),
            ("fprev", fprev, (3, ng, n), f32), ("nrm", nrm, (3, ng, n), f32),
            ("h_a", h_a, (ng, n), f32), ("ax", ax, (ng, n), f32),
            ("ay", ay, (ng, n), f32), ("friction", friction, (n,), f32),
            ("radius", gc.radius, (ng,), f32),
            ("m_solo", gc.m_solo, (ng,), f32),
            ("m_body", gc.m_body, (ng,), f32), ("w6", gc.w6, (6, ng), f32),
            ("geom_body", gc.geom_body, (ng,), torch.int32))
    for name, t, shape, dtype in args:
        kernel.check(name, t, shape, dev, dtype)
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")

    gF = torch.empty((3, ng, n), dtype=f32, device=dev)
    cf = torch.empty((3, ng, n), dtype=f32, device=dev)
    share_f = torch.empty((ng, n), dtype=f32, device=dev)
    active = torch.empty((ng, n), dtype=torch.bool, device=dev)
    KERNEL.launch(dev, *(t.data_ptr() for _, t, _, _ in args),
                  gF.data_ptr(), cf.data_ptr(), share_f.data_ptr(),
                  active.data_ptr(), ng, gc.nb, n, cp.baumgarte,
                  cp.max_depen_vel, cp.warm_growth * 9.81, cp.warm_decay,
                  cp.relax, cp.slop, cp.fn_max, dt)
    return gF, cf, active, share_f
