"""Articulated rigid-body kinematics, the CRBA mass matrix, the RNEA bias
forces and body jacobians (torch).

Counterpart of dwbc_tpu/sim/dynamics.py: `fk`, `crba`, `aba`, `rnea_bias`
and `body_jacobian`. The JAX functions take ONE env's state and are
vmapped by their callers; these take any leading batch dimensions on q,
qd and the inertial parameters directly, and compute on q's device. With
no batch dimension they serve sim/engine.build_ctx (build-time work on
the CPU); with a batch of envs they serve the OSC expert of
envs/widowgo1.py and the unfused step of sim/engine.py. The envs step
through the batched FK + ABA of sim/fused.py.

Generalized coordinates: q = [base pos(3), base quat xyzw(4), joints(nj)],
qd = [base lin vel (world), base ang vel (world), joint vels].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    """Forward-kinematics result (leading batch dims as q's)."""

    rot: torch.Tensor    # (..., nb, 3, 3) body->world rotation
    pos: torch.Tensor    # (..., nb, 3) body origin in world
    vel: torch.Tensor    # (..., nb, 6) spatial velocity [ang; lin], body coords
    j_rot: torch.Tensor  # (..., nb, 3, 3) pose of body i in parent coords
    j_pos: torch.Tensor  # (..., nb, 3)


def _mv(R, v):
    """R @ v over leading batch dims: R (..., m, n), v (..., n)."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def _mtv(R, v):
    return _mv(R.transpose(-1, -2), v)


def _motion_subspace(model: RobotModel, device) -> torch.Tensor:
    """S (nb, 6) in body coords: [axis; 0] revolute, [0; axis] prismatic."""
    axis = _f32(model.joint_axis, device)
    prism = torch.as_tensor(model.joint_type == 1, device=device)
    zeros = torch.zeros_like(axis)
    return torch.where(prism[:, None], torch.cat([zeros, axis], -1),
                       torch.cat([axis, zeros], -1))


def _joint_transform(model: RobotModel, q_j: torch.Tensor):
    """Pose of each body frame in its parent body frame (..., nb, ...),
    plus the motion subspace S (nb, 6)."""
    dev = q_j.device
    axis = _f32(model.joint_axis, dev)
    tree_rot = _f32(model.tree_rot, dev)
    tree_pos = _f32(model.tree_pos, dev)
    prism = torch.as_tensor(model.joint_type == 1, device=dev)
    qj = torch.cat([torch.zeros_like(q_j[..., :1]), q_j], -1)   # (..., nb)
    r_rev = maths.quat_to_mat(maths.quat_from_axis_angle(axis, qj))
    r_joint = torch.where(prism[:, None, None], torch.eye(3, device=dev),
                          r_rev)
    p_joint = torch.where(prism[:, None], axis * qj[..., None], 0.0)
    j_rot = tree_rot @ r_joint
    j_pos = tree_pos + _mv(tree_rot, p_joint)
    return j_rot, j_pos, _motion_subspace(model, dev)


def fk(model: RobotModel, q: torch.Tensor, qd: torch.Tensor) -> Kin:
    """Forward kinematics + velocities; q (..., nq), qd (..., nv)."""
    base_rot = maths.quat_to_mat(q[..., 3:7])
    v0 = torch.cat([_mtv(base_rot, qd[..., 3:6]),
                    _mtv(base_rot, qd[..., 0:3])], -1)
    j_rot, j_pos, S = _joint_transform(model, q[..., 7:])
    rots, poss, vels = [base_rot], [q[..., 0:3]], [v0]
    for i in range(1, model.nb):
        p = int(model.parent[i])
        Ri, pi = j_rot[..., i, :, :], j_pos[..., i, :]
        rots.append(rots[p] @ Ri)
        poss.append(_mv(rots[p], pi) + poss[p])
        w_p, u_p = vels[p][..., :3], vels[p][..., 3:]
        vi = torch.cat([_mtv(Ri, w_p),
                        _mtv(Ri, u_p + torch.linalg.cross(w_p, pi))], -1)
        vels.append(vi + S[i] * qd[..., 6 + i - 1, None])
    return Kin(rot=torch.stack(rots, -3), pos=torch.stack(poss, -2),
               vel=torch.stack(vels, -2), j_rot=j_rot, j_pos=j_pos)


def _spatial_inertias(inert: Inertial) -> torch.Tensor:
    """(..., nb, 6, 6) spatial inertias about body origins."""
    return spatial.spatial_inertia(inert.mass, inert.com, inert.inertia)


def _gravity_wrench(kin: Kin, inert: Inertial, gravity: torch.Tensor):
    """Per-body gravity as spatial force [n; f] in BODY coords at origin."""
    g_b = _mtv(kin.rot, gravity)                       # (..., nb, 3)
    f = inert.mass[..., None] * g_b
    n = torch.linalg.cross(inert.com.expand_as(f), f)
    return torch.cat([n, f], -1)


def world_wrench_to_body(kin: Kin, f_ext_world: torch.Tensor) -> torch.Tensor:
    """Convert (..., nb, 6) world-frame wrenches [n; f] at body origins
    into body coordinates."""
    return torch.cat([_mtv(kin.rot, f_ext_world[..., :3]),
                      _mtv(kin.rot, f_ext_world[..., 3:])], -1)


def aba(model: RobotModel, inert: Inertial, q: torch.Tensor,
        qd: torch.Tensor, tau: torch.Tensor,
        f_ext_world: Optional[torch.Tensor] = None,
        gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81),
        kin: Optional[Kin] = None) -> Tuple[torch.Tensor, Kin]:
    """Articulated-body forward dynamics over any leading batch dims.

    tau: (..., nj) joint torques. f_ext_world: optional (..., nb, 6) world
    wrenches [torque; force] at body origins (contacts, pushes).
    Returns qdd = (..., nv) = [base lin acc (world), base ang acc (world),
    joint accs] and the Kin used."""
    nb = model.nb
    if kin is None:
        kin = fk(model, q, qd)
    j_rot, j_pos, S = _joint_transform(model, q[..., 7:])
    I_sp = _spatial_inertias(inert)
    f_bias = _gravity_wrench(kin, inert, _f32(gravity, q.device))
    if f_ext_world is not None:
        f_bias = f_bias + world_wrench_to_body(kin, f_ext_world)

    # pass 1: velocity products and bias forces
    v = kin.vel
    c = [torch.zeros_like(v[..., 0, :])]
    for i in range(1, nb):
        c.append(spatial.cross_motion(v[..., i, :],
                                      S[i] * qd[..., 6 + i - 1, None]))
    pA = list((spatial.cross_force(v, _mv(I_sp, v)) - f_bias).unbind(-2))
    IA = list(I_sp.unbind(-3))

    # pass 2: inward articulated inertia recursion
    U, d, u = [None] * nb, [None] * nb, [None] * nb
    armature = _f32(model.dof_armature, q.device)
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        U[i] = _mv(IA[i], S[i])
        d[i] = (S[i] * U[i]).sum(-1) + armature[i - 1]
        u[i] = tau[..., i - 1] - (S[i] * pA[i]).sum(-1)
        Ia = IA[i] - U[i][..., :, None] * U[i][..., None, :] / d[i][..., None,
                                                                    None]
        pa = pA[i] + _mv(Ia, c[i]) + U[i] * (u[i] / d[i])[..., None]
        Xf = spatial.x_force(j_rot[..., i, :, :], j_pos[..., i, :])
        Xm_inv = spatial.x_motion_inv(j_rot[..., i, :, :], j_pos[..., i, :])
        IA[p] = IA[p] + Xf @ Ia @ Xm_inv
        pA[p] = pA[p] + _mv(Xf, pa)

    # pass 3: outward accelerations
    # base spatial accel, body coords; a singular IA[0] gives non-finite
    # values as jnp.linalg.solve does, with no raise and no host wait
    a0 = torch.linalg.solve_ex(IA[0], -pA[0][..., None],
                               check_errors=False)[0][..., 0]
    a = [a0]
    qdd_j = []
    for i in range(1, nb):
        Ri, pi = j_rot[..., i, :, :], j_pos[..., i, :]
        ap = a[int(model.parent[i])]
        w_p, u_p = ap[..., :3], ap[..., 3:]
        a_in = torch.cat([_mtv(Ri, w_p),
                          _mtv(Ri, u_p + torch.linalg.cross(w_p, pi))],
                         -1) + c[i]
        qdd_i = (u[i] - (U[i] * a_in).sum(-1)) / d[i]
        qdd_j.append(qdd_i)
        a.append(a_in + S[i] * qdd_i[..., None])

    # base spatial accel (body coords) -> world coordinate accelerations
    R0 = kin.rot[..., 0, :, :]
    w_b, v_b = kin.vel[..., 0, :3], kin.vel[..., 0, 3:]
    ang_acc_w = _mv(R0, a0[..., :3])
    lin_acc_w = _mv(R0, a0[..., 3:] + torch.linalg.cross(w_b, v_b))
    joint_qdd = (torch.stack(qdd_j, -1) if qdd_j
                 else q.new_zeros(q.shape[:-1] + (0,)))
    return torch.cat([lin_acc_w, ang_acc_w, joint_qdd], -1), kin


def crba(model: RobotModel, inert: Inertial, q: torch.Tensor) -> torch.Tensor:
    """Composite-rigid-body mass matrix (..., nv, nv); base block first,
    in base-body coordinates."""
    nb, nv = model.nb, model.nv
    j_rot, j_pos, S = _joint_transform(model, q[..., 7:])
    I_sp = spatial.spatial_inertia(inert.mass, inert.com, inert.inertia)
    batch = torch.broadcast_shapes(q.shape[:-1], I_sp.shape[:-3])
    Ic = list(I_sp.unbind(-3))
    Xf = [None] + [spatial.x_force(j_rot[..., i, :, :], j_pos[..., i, :])
                   for i in range(1, nb)]
    Xm_inv = [None] + [spatial.x_motion_inv(j_rot[..., i, :, :],
                                            j_pos[..., i, :])
                       for i in range(1, nb)]
    M = torch.zeros(batch + (nv, nv), device=q.device)
    armature = _f32(model.dof_armature, q.device)
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        Ic[p] = Ic[p] + Xf[i] @ Ic[i] @ Xm_inv[i]
        F = _mv(Ic[i], S[i])
        M[..., 6 + i - 1, 6 + i - 1] = (F * S[i]).sum(-1) + armature[i - 1]
        jj = i
        while int(model.parent[jj]) > 0:
            pj = int(model.parent[jj])
            F = _mv(Xf[jj], F)
            M[..., 6 + i - 1, 6 + pj - 1] = (F * S[pj]).sum(-1)
            M[..., 6 + pj - 1, 6 + i - 1] = (F * S[pj]).sum(-1)
            jj = pj
        F = _mv(Xf[jj], F)  # coupling with the base
        M[..., :6, 6 + i - 1] = F
        M[..., 6 + i - 1, :6] = F
    M[..., :6, :6] = Ic[0]
    return M


def rnea_bias(model: RobotModel, inert: Inertial, q: torch.Tensor,
              qd: torch.Tensor,
              gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81),
              kin: Optional[Kin] = None) -> torch.Tensor:
    """Nonlinear bias forces C(q,qd)qd + g(q): generalized forces
    (..., nv) with the base block in base-body coordinates [n; f]."""
    nb = model.nb
    if kin is None:
        kin = fk(model, q, qd)
    j_rot, j_pos, S = kin.j_rot, kin.j_pos, _motion_subspace(model, q.device)
    I_sp = spatial.spatial_inertia(inert.mass, inert.com, inert.inertia)
    f_grav = _gravity_wrench(kin, inert, _f32(gravity, q.device))
    v = kin.vel

    # outward: accelerations with qdd = 0 (velocity products only)
    a = [torch.zeros_like(v[..., 0, :])]
    for i in range(1, nb):
        Ri, pi = j_rot[..., i, :, :], j_pos[..., i, :]
        ap = a[int(model.parent[i])]
        a_in = torch.cat([_mtv(Ri, ap[..., :3]),
                          _mtv(Ri, ap[..., 3:]
                               + torch.linalg.cross(ap[..., :3], pi))], -1)
        a.append(a_in + spatial.cross_motion(
            v[..., i, :], S[i] * qd[..., 6 + i - 1, None]))
    a = torch.stack(a, -2)
    f = list((_mv(I_sp, a) + spatial.cross_force(v, _mv(I_sp, v))
              - f_grav).unbind(-2))
    tau = [None] * (nb - 1)
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        tau[i - 1] = (f[i] * S[i]).sum(-1)
        f[p] = f[p] + _mv(spatial.x_force(j_rot[..., i, :, :],
                                          j_pos[..., i, :]), f[i])
    return torch.cat([f[0], torch.stack(tau, -1)], -1)


def body_jacobian(model: RobotModel, q: torch.Tensor, body: int,
                  offset: Optional[torch.Tensor] = None,
                  kin: Optional[Kin] = None) -> torch.Tensor:
    """World-frame jacobian (..., 6, nv) of a point on `body`: rows
    [lin; ang] (IsaacGym's jacobian row layout, reference widowGo1.py:557).
    Columns: [base lin (world), base ang (world), joints]. `kin` may carry
    an FK of the same q (its velocities are not read)."""
    if kin is None:
        kin = fk(model, q, torch.zeros(q.shape[:-1] + (model.nv,),
                                       device=q.device))
    rot_b, pos_b = kin.rot[..., body, :, :], kin.pos[..., body, :]
    p_point = pos_b if offset is None else pos_b + _mv(rot_b, offset)
    nv = model.nv
    zero3 = torch.zeros_like(p_point)
    lin_cols = [zero3] * nv
    ang_cols = [zero3] * nv
    eye = torch.eye(3, device=q.device)
    skew = spatial.skew(p_point - kin.pos[..., 0, :])
    for k in range(3):
        # base columns: lin vel -> identity; ang vel w -> w x (p - p_base)
        lin_cols[k] = eye[:, k].expand_as(zero3)
        lin_cols[3 + k] = -skew[..., :, k]
        ang_cols[3 + k] = eye[:, k].expand_as(zero3)
    # joint columns: walk the ancestors of `body`
    axis = _f32(model.joint_axis, q.device)
    i = body
    while i > 0:
        ax_w = _mv(kin.rot[..., i, :, :], axis[i])
        if int(model.joint_type[i]) == 0:  # revolute
            lin_cols[6 + i - 1] = torch.linalg.cross(
                ax_w, p_point - kin.pos[..., i, :])
            ang_cols[6 + i - 1] = ax_w
        else:  # prismatic
            lin_cols[6 + i - 1] = ax_w
        i = int(model.parent[i])
    return torch.cat([torch.stack(lin_cols, -1), torch.stack(ang_cols, -1)],
                     -2)
