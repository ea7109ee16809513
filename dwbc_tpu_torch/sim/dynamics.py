"""Articulated rigid-body kinematics and the CRBA mass matrix (torch).

Counterpart of dwbc_tpu/sim/dynamics.py, build-time subset: `fk` and
`crba` for ONE env, used by sim/engine.build_ctx to precompute the
contact effective masses. The per-substep dynamics (batched FK + ABA)
live in sim/fused.py.

Generalized coordinates: q = [base pos(3), base quat xyzw(4), joints(nj)],
qd = [base lin vel (world), base ang vel (world), joint vels].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import maths, spatial
from ..core.model import RobotModel
from ..utils.device import resolve_device


def _f32(a, device="cpu") -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


class Inertial(NamedTuple):
    """Per-body inertial params (batched over envs in EnvState)."""

    mass: torch.Tensor     # (..., nb)
    com: torch.Tensor      # (..., nb, 3)
    inertia: torch.Tensor  # (..., nb, 3, 3) about com


def default_inertial(model: RobotModel, device="cuda") -> Inertial:
    dev = resolve_device(device)
    return Inertial(mass=_f32(model.mass, dev), com=_f32(model.com, dev),
                    inertia=_f32(model.inertia, dev))


class Kin(NamedTuple):
    """Forward-kinematics result for one env."""

    rot: torch.Tensor    # (nb, 3, 3) body->world rotation
    pos: torch.Tensor    # (nb, 3) body origin in world
    vel: torch.Tensor    # (nb, 6) spatial velocity [ang; lin], body coords
    j_rot: torch.Tensor  # (nb, 3, 3) pose of body i in parent coords
    j_pos: torch.Tensor  # (nb, 3)


def _joint_transform(model: RobotModel, q_j: torch.Tensor):
    """Pose of each body frame in its parent body frame, plus the motion
    subspace S (nb, 6)."""
    axis = _f32(model.joint_axis)
    tree_rot = _f32(model.tree_rot)
    tree_pos = _f32(model.tree_pos)
    prism = torch.as_tensor(model.joint_type == 1)
    qj = torch.cat([torch.zeros(1), q_j])
    r_rev = maths.quat_to_mat(maths.quat_from_axis_angle(axis, qj))
    r_joint = torch.where(prism[:, None, None], torch.eye(3), r_rev)
    p_joint = torch.where(prism[:, None], axis * qj[:, None], 0.0)
    j_rot = tree_rot @ r_joint
    j_pos = tree_pos + (tree_rot @ p_joint[..., None])[..., 0]
    zeros = torch.zeros_like(axis)
    S = torch.where(prism[:, None], torch.cat([zeros, axis], -1),
                    torch.cat([axis, zeros], -1))
    return j_rot, j_pos, S


def fk(model: RobotModel, q: torch.Tensor, qd: torch.Tensor) -> Kin:
    """Forward kinematics + velocities for one env (CPU, float32)."""
    base_rot = maths.quat_to_mat(q[3:7])
    v0 = torch.cat([base_rot.T @ qd[3:6], base_rot.T @ qd[0:3]])
    j_rot, j_pos, S = _joint_transform(model, q[7:])
    rots, poss, vels = [base_rot], [q[0:3]], [v0]
    for i in range(1, model.nb):
        p = int(model.parent[i])
        Ri, pi = j_rot[i], j_pos[i]
        rots.append(rots[p] @ Ri)
        poss.append(rots[p] @ pi + poss[p])
        w_p, u_p = vels[p][:3], vels[p][3:]
        vi = torch.cat([Ri.T @ w_p, Ri.T @ (u_p + torch.linalg.cross(w_p, pi))])
        vels.append(vi + S[i] * qd[6 + i - 1])
    return Kin(rot=torch.stack(rots), pos=torch.stack(poss),
               vel=torch.stack(vels), j_rot=j_rot, j_pos=j_pos)


def crba(model: RobotModel, inert: Inertial, q: torch.Tensor) -> torch.Tensor:
    """Composite-rigid-body mass matrix (nv, nv); base block first, in
    base-body coordinates."""
    nb, nv = model.nb, model.nv
    j_rot, j_pos, S = _joint_transform(model, q[7:])
    Ic = list(spatial.spatial_inertia(inert.mass, inert.com, inert.inertia))
    Xf = [None] + [spatial.x_force(j_rot[i], j_pos[i]) for i in range(1, nb)]
    Xm_inv = [None] + [spatial.x_motion_inv(j_rot[i], j_pos[i])
                       for i in range(1, nb)]
    M = torch.zeros((nv, nv))
    armature = _f32(model.dof_armature)
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        Ic[p] = Ic[p] + Xf[i] @ Ic[i] @ Xm_inv[i]
        F = Ic[i] @ S[i]
        M[6 + i - 1, 6 + i - 1] = S[i] @ F + armature[i - 1]
        jj = i
        while int(model.parent[jj]) > 0:
            pj = int(model.parent[jj])
            F = Xf[jj] @ F
            M[6 + i - 1, 6 + pj - 1] = S[pj] @ F
            M[6 + pj - 1, 6 + i - 1] = S[pj] @ F
            jj = pj
        F = Xf[jj] @ F  # coupling with the base
        M[:6, 6 + i - 1] = F
        M[6 + i - 1, :6] = F
    M[:6, :6] = Ic[0]
    return M
