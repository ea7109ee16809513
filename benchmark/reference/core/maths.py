"""Quaternion / rotation / spherical-coordinate math on torch tensors.

Counterpart of dwbc_tpu/core/maths.py.
Conventions are the reference's:
  * quaternions are (x, y, z, w);
  * euler angles are extrinsic XYZ (roll, pitch, yaw);
  * spherical coordinates are (l, pitch, yaw) with
    x = l cos(p) cos(y), y = l cos(p) sin(y), z = l sin(p).

All functions broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import resolve_device


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=dim, keepdim=True) + eps)


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


# ---------------------------------------------------------------------------
# quaternion algebra (xyzw)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body->world if q is body orientation)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^{-1} (world->body)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v - w * t + torch.linalg.cross(xyz, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R such that R @ v == quat_rotate(q, v)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> xyzw quaternion (branch-free, Shepperd-style)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return normalize(torch.stack([qx, qy, qz, qw], dim=-1))


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def euler_from_quat(q: torch.Tensor):
    """Extrinsic XYZ (roll, pitch, yaw) from xyzw quaternion."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion keeping only the yaw component of q."""
    _, _, yaw = euler_from_quat(q)
    z = torch.zeros_like(yaw)
    return quat_from_euler_xyz(z, z, yaw)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw of q (reference legged_gym
    utils/math.py:38-42)."""
    return quat_rotate(yaw_quat(q), v)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor,
                   dt) -> torch.Tensor:
    """Integrate orientation with world-frame angular velocity."""
    dq = quat_mul(torch.cat([omega_world,
                             torch.zeros_like(omega_world[..., :1])], -1), q)
    return normalize(q + 0.5 * dt * dq)


# ---------------------------------------------------------------------------
# spherical coords (l, pitch, yaw)


def sphere2cart(s: torch.Tensor) -> torch.Tensor:
    l, p, y = s.unbind(-1)
    cp = torch.cos(p)
    return torch.stack([l * cp * torch.cos(y), l * cp * torch.sin(y),
                        l * torch.sin(p)], dim=-1)


def cart2sphere(c: torch.Tensor) -> torch.Tensor:
    l = torch.linalg.norm(c, dim=-1)
    safe_l = torch.clamp(l, min=1e-9)
    p = torch.asin(torch.clamp(c[..., 2] / safe_l, -1.0, 1.0))
    y = torch.atan2(c[..., 1], c[..., 0])
    return torch.stack([l, p, y], dim=-1)


# ---------------------------------------------------------------------------
# random draws from an explicit generator (the keyed helpers' counterparts)


def uniform(gen: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    """U[lo, hi) draws; lo/hi broadcast against `shape`."""
    return lo + torch.rand(shape, generator=gen, device=device) * (hi - lo)


def rand_sign(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.where(torch.rand(shape, generator=gen, device=device) < 0.5,
                       1.0, -1.0)


# ---------------------------------------------------------------------------
# small-matrix linear algebra


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD matrices A (..., n, n) by a Cholesky
    factorisation with every pivot floored at 1e-12, batched over the
    leading dims (n is small, 6 for the OSC task-space inertia). b is
    (..., n) or (..., n, k). The reference's algorithm
    (dwbc_tpu/core/maths.py solve_spd) with its order of operations: a
    singular matrix solves against its floored pivot and a NaN reaches
    only its own matrix's solution. Nothing raises, and nothing waits
    for the device."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    # cols[j][..., r] is L[j + r, j]: column j of the factor, from the
    # diagonal down
    cols = []
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k, None]
        d = torch.sqrt(torch.clamp(s[..., :1], min=1e-12))
        cols.append(torch.cat([d, s[..., 1:] / d], -1))
    # L y = b, column by column: row i subtracts its terms in k order
    s = b[..., None] if vec else b
    y = []
    for k in range(n):
        y.append(s[..., 0, :] / cols[k][..., :1])
        s = s[..., 1:, :] - cols[k][..., 1:, None] * y[k][..., None, :]
    # L^T x = y, row by row
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - cols[i][..., k - i, None] * x[k]
        x[i] = s / cols[i][..., :1]
    x = torch.stack(x, -2)
    return x[..., 0] if vec else x
