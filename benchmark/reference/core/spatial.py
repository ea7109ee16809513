"""6D spatial-vector algebra (Featherstone convention) on torch tensors.

Counterpart of dwbc_tpu/core/spatial.py. Motion vectors are
[angular(3); linear(3)], force vectors [torque(3); force(3)]. Frames are
(R, p): R takes local coordinates to the parent/world frame, p is the
frame origin in the parent/world frame.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _blocks(tl, tr, bl, br):
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


# spatial transforms for the pose (R, p) of frame B expressed in frame A


def x_force(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Force transform B->A: f_A = x_force(R, p) @ f_B."""
    return _blocks(R, skew(p) @ R, torch.zeros_like(R), R)


def x_motion_inv(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Motion transform A->B for pose (R, p) of B in A."""
    Rt = R.transpose(-1, -2)
    return _blocks(Rt, torch.zeros_like(R), -Rt @ skew(p), Rt)


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    w, u = v[..., :3], v[..., 3:]
    mw, mu = m[..., :3], m[..., 3:]
    return torch.cat([torch.linalg.cross(w, mw),
                      torch.linalg.cross(w, mu) + torch.linalg.cross(u, mw)], -1)


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    w, u = v[..., :3], v[..., 3:]
    fw, fu = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, fw) + torch.linalg.cross(u, fu),
                      torch.linalg.cross(w, fu)], -1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body frame origin, batched over any
    leading dims: mass (...,), com (..., 3) origin->com, inertia_com
    (..., 3, 3) about the com."""
    c = skew(com)
    m = mass[..., None, None]
    I = inertia_com + m * (c @ c.transpose(-1, -2))
    eye = torch.eye(3, dtype=I.dtype, device=I.device).expand_as(c)
    return _blocks(I, m * c, -m * c, m * eye)
