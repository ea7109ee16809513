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
(ops/aba_kernel.aba is the drop-in that picks between them). Both read
the tree's constants from a `TreeConst` (sim/tree.py).
"""

from __future__ import annotations

import torch

from ..core import spatial
from .tree import TreeConst, _mtv, _mv, joint_frame


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
