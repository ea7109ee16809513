"""The fused substep's articulated-body algorithm, plain PyTorch version.

`fused_aba` computes what one physics substep of sim/fused.py needs after
the contact law: the joint-space extra torques (limit spring and damper,
viscous and Coulomb friction capped by the torque that stops the joint in
one dt), the body-frame bias forces (gravity through the com, the contact
wrenches), the velocity-product terms, ABA's backward pass over the tree,
the base's 6x6 Cholesky solve with a 1e-6 pivot floor, the forward pass
for the joint accelerations, and the base's world accelerations.

It runs on batched tensors ((N, 3, 3) rotations, (N, 6, 6) articulated
inertias) with a Python loop over the bodies: the version that runs on
CPU tensors, and the oracle of the CUDA kernel csrc/aba.cu
(ops/aba_kernel.aba is the drop-in that picks between them).
`TreeConst` holds the tree's constants for both, built once per
simulator by `tree_const`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import spatial
from ..core.model import RobotModel
from ..utils.device import resolve_device

# columns of TreeConst.table, one row per body (of row 0, the base, the
# kernel reads only the parent, -1): the layout csrc/aba.cu reads
PARENT, PRISMATIC, AXIS, TREE_ROT, TREE_POS, PRISM_DIR = 0, 1, 2, 5, 14, 17
ARMATURE, DAMPING, FRICTION, LOWER, UPPER, I_EFF = 20, 21, 22, 23, 24, 25
TABLE_W = 28


class TreeConst(NamedTuple):
    """A kinematic tree's constants on the simulator's device."""

    nb: int
    parent: List[int]
    prismatic: List[bool]
    armature: List[float]
    S: torch.Tensor           # (nb, 6) motion subspaces in body coords
    tree_rot: torch.Tensor    # (nb, 3, 3)
    tree_pos: torch.Tensor    # (nb, 3)
    axis_outer: torch.Tensor  # (nb, 3, 3) a a^T
    axis_skew: torch.Tensor   # (nb, 3, 3) skew(a)
    prism_dir: torch.Tensor   # (nb, 3, 1) tree_rot @ a
    eye3: torch.Tensor
    damping: torch.Tensor     # (nj,) per dof
    friction: torch.Tensor
    dof_lo: torch.Tensor
    dof_hi: torch.Tensor
    i_eff: torch.Tensor
    gvec: torch.Tensor        # (3,)
    gravity: Tuple[float, float, float]
    limit_kp: float
    limit_kd: float
    dt: float
    table: torch.Tensor       # (nb, TABLE_W) float32, the kernel's copy


def tree_const(model: RobotModel, params, i_eff, device="cuda") -> TreeConst:
    """The constants of `model`'s tree for `params` (sim/engine.SimParams)
    and the joints' effective inertias `i_eff` (nj,), uploaded once to
    `device`. Raises ValueError unless every body's parent precedes it and
    every joint is revolute (0) or prismatic (1)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    nb = model.nb
    parent = [int(p) for p in model.parent]
    jtype = [int(t) for t in model.joint_type]
    if parent[0] != -1 or any(not 0 <= parent[i] < i for i in range(1, nb)):
        raise ValueError(f"tree: every body's parent must precede it, got "
                         f"{parent}")
    if any(t not in (0, 1) for t in jtype[1:]):
        raise ValueError(f"tree: joint types must be 0 or 1, got {jtype}")
    prismatic = [t == 1 for t in jtype]
    axes = np.asarray(model.joint_axis, np.float64)
    tree_rot = f32(model.tree_rot)
    # motion subspaces: [axis; 0] revolute, [0; axis] prismatic
    S = f32([np.concatenate([np.zeros(3), axes[i]]) if prismatic[i]
             else np.concatenate([axes[i], np.zeros(3)]) for i in range(nb)])
    prism_dir = tree_rot @ f32(axes)[..., None]
    tree_rot_np = np.asarray(model.tree_rot, np.float32)
    i_eff_np = np.asarray(torch.as_tensor(i_eff).cpu(), np.float32)

    table = np.zeros((nb, TABLE_W), np.float32)
    table[:, PARENT] = parent
    table[:, PRISMATIC] = prismatic
    table[:, AXIS:AXIS + 3] = axes
    table[:, TREE_ROT:TREE_ROT + 9] = tree_rot_np.reshape(nb, 9)
    table[:, TREE_POS:TREE_POS + 3] = model.tree_pos
    table[:, PRISM_DIR:PRISM_DIR + 3] = np.einsum(
        "bij,bj->bi", tree_rot_np, axes.astype(np.float32))
    for col, per_dof in ((ARMATURE, model.dof_armature),
                         (DAMPING, model.dof_damping),
                         (FRICTION, model.dof_friction),
                         (LOWER, model.dof_lower), (UPPER, model.dof_upper),
                         (I_EFF, i_eff_np)):
        table[1:, col] = per_dof
    return TreeConst(
        nb=nb, parent=parent, prismatic=prismatic,
        armature=[float(a) for a in model.dof_armature], S=S,
        tree_rot=tree_rot, tree_pos=f32(model.tree_pos),
        axis_outer=f32([np.outer(a, a) for a in axes]),
        axis_skew=f32([[[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                        [-a[1], a[0], 0.0]] for a in axes]),
        prism_dir=prism_dir, eye3=torch.eye(3, device=dev),
        damping=f32(model.dof_damping), friction=f32(model.dof_friction),
        dof_lo=f32(model.dof_lower), dof_hi=f32(model.dof_upper),
        i_eff=f32(i_eff_np), gvec=f32(params.gravity),
        gravity=tuple(float(g) for g in params.gravity),
        limit_kp=params.limit_kp, limit_kd=params.limit_kd, dt=params.dt,
        table=torch.as_tensor(table, device=dev))


def joint_frame(tc: TreeConst, i: int, qi: torch.Tensor):
    """Pose (Rj (N, 3, 3), jp (N, 3) or (3,)) of body i in its parent.
    Revolute: R(q) = c I + (1 - c) a a^T + s skew(a) after tree_rot."""
    if tc.prismatic[i]:
        return (tc.tree_rot[i].expand(qi.shape[0], 3, 3),
                tc.tree_pos[i] + tc.prism_dir[i, :, 0] * qi[:, None])
    c = torch.cos(qi)[:, None, None]
    s = torch.sin(qi)[:, None, None]
    Ra = tc.eye3 * c + tc.axis_outer[i] * (1 - c) + tc.axis_skew[i] * s
    return tc.tree_rot[i] @ Ra, tc.tree_pos[i]


def _mv(R, v):
    """R @ v over the batch: R (..., 3, 3), v (..., 3) or a constant (3,)."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def _mtv(R, v):
    return _mv(R.transpose(-1, -2), v)


def _transform_abi(Ia, Rj, pj):
    """Parent-frame articulated-body inertia X_f Ia X_m for the joint frame
    (Rj, pj), by Featherstone's block formula: with Ia = [[A, B], [B^T, D]],
    D' = R D R^T, B' = R B R^T + p^ D', A' = R A R^T + p^ (R B^T R^T)
    - (R B R^T) p^ - p^ D' p^ (p^ = skew(p))."""
    A, B, D = Ia[:, :3, :3], Ia[:, :3, 3:], Ia[:, 3:, 3:]
    Rt = Rj.transpose(-1, -2)
    Ar = Rj @ A @ Rt
    Br = Rj @ B @ Rt
    Dr = Rj @ D @ Rt
    P = spatial.skew(pj)
    pDr = P @ Dr
    Atl = (Ar + P @ Br.transpose(-1, -2)) - (Br @ P + pDr @ P)
    Btr = Br + pDr
    return torch.cat([torch.cat([Atl, Btr], -1),
                      torch.cat([Btr.transpose(-1, -2), Dr], -1)], -2)


def _spd_solve6(M, b):
    """Solve M x = b for batched SPD 6x6 M (N, 6, 6), b (N, 6) by Cholesky
    with a 1e-6 pivot floor: a pivot that small means a numerically
    singular articulated inertia, where a bounded acceleration beats
    1e12-scale garbage."""
    L = torch.zeros_like(M)
    for j in range(6):
        Ljj = torch.sqrt(torch.clamp(
            M[:, j, j] - (L[:, j, :j] * L[:, j, :j]).sum(-1), min=1e-6))
        L[:, j, j] = Ljj
        if j < 5:
            L[:, j + 1:, j] = (M[:, j + 1:, j]
                               - (L[:, j + 1:, :j] @ L[:, j, :j, None])[..., 0]
                               ) / Ljj[:, None]
    y = torch.empty_like(b)
    for i in range(6):
        y[:, i] = (b[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) / L[:, i, i]
    x = torch.empty_like(b)
    for i in reversed(range(6)):
        x[:, i] = (y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)) / L[:, i, i]
    return x


def fused_aba(tc: TreeConst, q, qd, tau, R_stack, v_stack, IA_body, mass,
              com, bF, bN):
    """One substep's accelerations. q (N, nq), qd (N, nv), tau (N, nj);
    R_stack (nb, N, 3, 3) body->world rotations and v_stack (nb, N, 6)
    body-frame spatial velocities [ang; lin]; IA_body (N, nb, 6, 6) spatial
    inertias, mass (N, nb), com (N, nb, 3); bF, bN (3, nb, N) world
    contact force and torque at the body origins. Returns qdd (N, nj) and
    the base's world angular and linear accelerations (N, 3) each."""
    nb, parent, S, armature = tc.nb, tc.parent, tc.S, tc.armature
    dt = tc.dt

    # ---------------- joint-space extra torques ----------------
    qj, qdj = q[:, 7:], qd[:, 6:]
    below = torch.clamp(qj - tc.dof_lo, max=0.0)
    above = torch.clamp(qj - tc.dof_hi, min=0.0)
    t = -tc.limit_kp * (below + above) * tc.i_eff
    stop = tc.i_eff * torch.abs(qdj) / dt
    mag = tc.damping * torch.abs(qdj) + tc.friction
    mag = mag + torch.where((below < 0) | (above > 0),
                            tc.limit_kd * torch.abs(qdj), 0.0)
    tau_eff = tau + (t - torch.sign(qdj) * torch.minimum(mag, stop))

    # ---------------- ABA ----------------
    Rs = R_stack.transpose(0, 1).contiguous()          # (N, nb, 3, 3)
    Rst = Rs.transpose(-1, -2)
    vs = v_stack.transpose(0, 1).contiguous()          # (N, nb, 6)
    bF, bN = bF.permute(2, 1, 0), bN.permute(2, 1, 0)  # (N, nb, 3)
    fg_lin = _mv(Rst, tc.gvec) * mass[..., None]
    f_bias = torch.cat(
        [torch.linalg.cross(com, fg_lin) + _mv(Rst, bN),
         fg_lin + _mv(Rst, bF)], -1)
    pA = list((spatial.cross_force(vs, _mv(IA_body, vs))
               - f_bias).unbind(1))
    qd_b = torch.cat([torch.zeros_like(qd[:, :1]), qdj], -1)  # (N, nb)
    c_vp = spatial.cross_motion(vs, S * qd_b[..., None]).unbind(1)
    IA = list(IA_body.unbind(1))

    jR, jp = [None] * nb, [None] * nb
    U, d_inv, u_ = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, 0, -1):
        pa = parent[i]
        Ui = IA[i] @ S[i]
        d_inv[i] = 1.0 / (Ui @ S[i] + armature[i - 1])
        u_[i] = tau_eff[:, i - 1] - pA[i] @ S[i]
        U[i] = Ui
        Ia = (IA[i] + Ui[:, :, None] * Ui[:, None, :]
              * (-d_inv[i])[:, None, None])
        pai = (pA[i] + _mv(Ia, c_vp[i])
               + Ui * (u_[i] * d_inv[i])[:, None])
        Rj, pj = jR[i], jp[i] = joint_frame(tc, i, q[:, 6 + i])
        Rfu = _mv(Rj, pai[:, 3:])
        fp_ang = _mv(Rj, pai[:, :3]) + torch.linalg.cross(
            pj.expand_as(Rfu), Rfu)
        pA[pa] = pA[pa] + torch.cat([fp_ang, Rfu], -1)
        IA[pa] = IA[pa] + _transform_abi(Ia, Rj, pj)

    a0 = _spd_solve6(IA[0], -pA[0])
    a = [a0]
    qdd = []
    for i in range(1, nb):
        Rj, pj = jR[i], jp[i]
        ap = a[parent[i]]
        aw = _mtv(Rj, ap[:, :3])
        au = _mtv(Rj, ap[:, 3:] + torch.linalg.cross(ap[:, :3],
                                                     pj.expand_as(aw)))
        a_in = torch.cat([aw, au], -1) + c_vp[i]
        qdd_i = (u_[i] - (U[i] * a_in).sum(-1)) * d_inv[i]
        qdd.append(qdd_i)
        a.append(a_in + S[i] * qdd_i[:, None])
    qdd = torch.stack(qdd, -1)

    # base acceleration to world coordinates
    R0, v0 = R_stack[0], v_stack[0]
    ang_acc_w = _mv(R0, a0[:, :3])
    lin_acc_w = _mv(R0, a0[:, 3:] + torch.linalg.cross(v0[:, :3], v0[:, 3:]))
    return qdd, ang_acc_w, lin_acc_w
