"""Batched physics substeps on torch tensors: FK, contact, box, ABA.

Counterpart of dwbc_tpu/sim/fused.py (`init_contact_carry`,
`make_fused_substep`). The JAX module scalarises every 3x3 and 6x6
product into tuples of (N,) arrays so that XLA fuses them; in eager
PyTorch each of those scalar ops would be its own kernel launch. Here
the same math runs on batched tensors instead — (N, 3, 3) rotations,
(N, 6, 6) articulated inertias, (N, nb, ...) per-body stacks — with a
Python loop over the static kinematic tree's bodies, and the contact
arrays keep the law's (ng, N) layout ((3, ng, N) for 3-vectors).

The terrain contact law runs through ops/contact_kernel.contact_law: the
CUDA kernel on the card, the plain law (sim/contact.py) on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import maths, spatial
from ..core.model import RobotModel
from ..ops.contact_kernel import contact_law
from ..terrain.terrain import Heightfield
from ..utils import spans
from ..utils.device import resolve_device
from .contact import GeomConst, m_dir
from .engine import PhysCtx, SimParams


class FusedOut(NamedTuple):
    q: torch.Tensor            # (N, nq)
    qd: torch.Tensor           # (N, nv)
    foot_forces: torch.Tensor  # (N, n_feet, 3) world forces on foot geoms
    body_forces: torch.Tensor  # (N, nb, 3) net contact force per body
    torques: torch.Tensor      # (N, nj) torques applied on the last substep
    # warm-start state fed back as `contact_carry` on the next policy step:
    # dict of (N, ng, 3) / (N, 8, 3) accumulated world contact forces
    contact_carry: dict


def init_contact_carry(model: RobotModel, num_envs: int, with_box: bool = False,
                       device="cuda") -> dict:
    """Zero warm-start contact state (see make_fused_substep)."""
    dev = resolve_device(device)
    ng = len(model.geom_body)
    d = {"terr": torch.zeros((num_envs, ng, 3), device=dev)}
    if with_box:
        d["boxg"] = torch.zeros((num_envs, ng, 3), device=dev)
        d["corner"] = torch.zeros((num_envs, 8, 3), device=dev)
    return d


def _mv(R, v):
    """R @ v over the batch: R (..., 3, 3), v (..., 3) or a constant (3,)."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def _mtv(R, v):
    return _mv(R.transpose(-1, -2), v)


def _cross0(a, b):
    """Cross product over dim 0 of (3, ...) component stacks."""
    return torch.linalg.cross(a, b, dim=0)


def _integrate_quat(quat, ang, dt):
    """Semi-implicit q += 0.5 dt (omega ⊗ q) with renormalisation;
    quat (N, 4) xyzw, ang (N, 3) world angular velocity."""
    qx, qy, qz, qw = quat.unbind(-1)
    ox, oy, oz = ang.unbind(-1)
    h = 0.5 * dt
    nx = qx + h * (qw * ox + oy * qz - oz * qy)
    ny = qy + h * (qw * oy - ox * qz + oz * qx)
    nz = qz + h * (qw * oz + ox * qy - oy * qx)
    nw = qw + h * (-ox * qx - oy * qy - oz * qz)
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + nw * nw + 1e-12)
    return torch.stack([nx * inv, ny * inv, nz * inv, nw * inv], -1)


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


def _solve3(M, b):
    """Solve M x = b for batched 3x3 M (N, 3, 3) via the adjugate (the
    box world-inertia solve: SPD, well-conditioned)."""
    a, bm, c = M[:, 0].unbind(-1)
    d, e, f = M[:, 1].unbind(-1)
    g, h, i = M[:, 2].unbind(-1)
    A = e * i - f * h
    B = c * h - bm * i
    C = bm * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = bm * g - a * h
    I = a * e - bm * d
    det = a * A + bm * D + c * G
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([(A * b0 + B * b1 + C * b2) * inv,
                        (D * b0 + E * b1 + F * b2) * inv,
                        (G * b0 + H * b1 + I * b2) * inv], -1)


def make_fused_substep(model: RobotModel, params: SimParams, hf: Heightfield,
                       ctx: PhysCtx, foot_geoms, device="cuda",
                       box_half_extents: Optional[Tuple[float, ...]] = None):
    """Build step(q, qd, tau_fn, mass, com, inertia, friction, n_steps, ...)
    running `n_steps` physics substeps on `device`. tau_fn(q, qd) -> (N, nj)
    joint torques is re-evaluated each substep (the reference's
    per-substep PD, widowGo1.py:1175-1191). A stateful torque law (the
    LSTM actuator net, reference anymal.py:71-78) passes its state as
    `tau_carry`: then tau_fn(carry, q, qd) -> (carry, tau) advances it once
    per substep and step() returns (out, tau_carry_out).

    With `box_half_extents`, a free box body is co-simulated inside the
    same substep: robot spheres contact the box OBB two-way, the box's 8
    rounded corners contact the terrain, and the box integrates as one
    Newton-Euler rigid body. step() then takes box_q (N, 7), box_qd (N, 6),
    box_mass (N,), box_i_diag (N, 3) and returns (out, box_q, box_qd)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    nb, nj = model.nb, model.nj
    parent = [int(p) for p in model.parent]
    prismatic = [int(t) == 1 for t in model.joint_type]
    axes = np.asarray(model.joint_axis, np.float64)
    tree_rot = f32(model.tree_rot)
    tree_pos = f32(model.tree_pos)
    # motion subspaces: [axis; 0] revolute, [0; axis] prismatic
    S = f32([np.concatenate([np.zeros(3), axes[i]]) if prismatic[i]
             else np.concatenate([axes[i], np.zeros(3)]) for i in range(nb)])
    # revolute joint rotation R(q) = c I + (1 - c) a a^T + s skew(a)
    eye3 = torch.eye(3, device=dev)
    axis_outer = f32([np.outer(a, a) for a in axes])
    axis_skew = f32([[[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                      [-a[1], a[0], 0.0]] for a in axes])
    prism_dir = tree_rot @ f32(axes)[..., None]  # (nb, 3, 1)
    armature = [float(a) for a in model.dof_armature]
    damping = f32(model.dof_damping)
    friction_j = f32(model.dof_friction)
    dof_lo = f32(model.dof_lower)
    dof_hi = f32(model.dof_upper)
    i_eff = f32(ctx.dof_i_eff)

    ng = len(model.geom_body)
    geom_body_np = np.asarray(model.geom_body, np.int64)
    if geom_body_np.min() < 0 or geom_body_np.max() >= nb:
        raise ValueError("geom_body indices out of range")
    gb = torch.as_tensor(geom_body_np, device=dev)
    geom_off = f32(model.geom_pos)[:, None, :, None]    # (ng, 1, 3, 1)
    w_np = np.asarray(ctx.w_geom, np.float32)             # (ng, 3, 3)
    gc = GeomConst(
        radius=f32(model.geom_radius),
        m_solo=f32(ctx.m_solo), m_body=f32(ctx.m_body),
        w6=f32([w_np[:, i, j] for i, j in
                ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]),
        geom_body=torch.as_tensor(geom_body_np.astype(np.int32), device=dev),
        nb=nb)
    radius_col = gc.radius[:, None]
    w6_col = gc.w6[:, :, None]
    # one-hot geom -> body incidence for the per-body wrench sums
    # (full float32: resolve_device turns TF32 off on the card)
    E = torch.zeros((nb, ng), device=dev)
    E[gb, torch.arange(ng, device=dev)] = 1.0
    foot_list = [int(g) for g in foot_geoms]
    foot_idx = torch.as_tensor(foot_list, dtype=torch.long, device=dev)
    gvec = f32(params.gravity)
    dt = params.dt
    cp = params.contact
    mv = params.max_base_vel

    # terrain sample-point plan: one sample per geom-carrying body plus an
    # exact sample per foot geom; every other geom takes its body sample's
    # tangent plane, evaluated at the geom's current position each substep
    sample_bodies = sorted(set(geom_body_np.tolist()))
    body_slot = {b: i for i, b in enumerate(sample_bodies)}
    nsb = len(sample_bodies)
    geom_slot = torch.as_tensor(
        [(nsb + foot_list.index(g)) if g in foot_list else body_slot[int(b)]
         for g, b in enumerate(geom_body_np)], dtype=torch.long, device=dev)
    sample_bodies_t = torch.as_tensor(sample_bodies, dtype=torch.long,
                                      device=dev)

    with_box = box_half_extents is not None
    if with_box:
        bhe = [float(h) for h in box_half_extents]
        box_r = 0.5 * min(bhe)
        box_corners = f32([[sx * (bhe[0] - box_r), sy * (bhe[1] - box_r),
                            sz * (bhe[2] - box_r)]
                           for sx in (-1, 1) for sy in (-1, 1)
                           for sz in (-1, 1)])            # (8, 3)
        bhe_col = f32(bhe)[:, None, None]

    def joint_frame(i, qi):
        """Pose (Rj (N, 3, 3), jp (N, 3) or (3,)) of body i in its parent."""
        if prismatic[i]:
            return (tree_rot[i].expand(qi.shape[0], 3, 3),
                    tree_pos[i] + prism_dir[i, :, 0] * qi[:, None])
        c = torch.cos(qi)[:, None, None]
        s = torch.sin(qi)[:, None, None]
        Ra = eye3 * c + axis_outer[i] * (1 - c) + axis_skew[i] * s
        return tree_rot[i] @ Ra, tree_pos[i]

    def fk(q, qd=None):
        """Batched FK: per-body world (R, p) lists, and with qd the body
        spatial velocities [ang; lin] in body coords plus joint frames."""
        R = [maths.quat_to_mat(q[:, 3:7])]
        p = [q[:, 0:3]]
        v = jR = jp = None
        if qd is not None:
            v = [torch.cat([_mtv(R[0], qd[:, 3:6]), _mtv(R[0], qd[:, 0:3])],
                           -1)]
            jR, jp = [None], [None]
        for i in range(1, nb):
            Rj, pj = joint_frame(i, q[:, 6 + i])
            pa = parent[i]
            R.append(R[pa] @ Rj)
            p.append(_mv(R[pa], pj) + p[pa])
            if qd is not None:
                wp, up = v[pa][:, :3], v[pa][:, 3:]
                w_i = _mtv(Rj, wp)
                u_i = _mtv(Rj, up + torch.linalg.cross(wp, pj.expand_as(wp)))
                v.append(torch.cat([w_i, u_i], -1) + S[i] * qd[:, 5 + i, None])
                jR.append(Rj)
                jp.append(pj)
        return R, p, v, jR, jp

    def geom_frames(R, p):
        """Per-geom rotations (ng, N, 3, 3) and world offsets (ng, N, 3)."""
        Rg = torch.stack(R)[gb]
        return Rg, (Rg @ geom_off).squeeze(-1), torch.stack(p)[gb]

    def sample_terrain(q):
        """Tangent-plane cache (h (ng, N), normal (3, ng, N), ax, ay),
        sampled once per policy step by the plan above."""
        R, p, *_ = fk(q)
        Rg, r_w, pg = geom_frames(R, p)
        foot_xy = (pg + r_w)[foot_idx][..., :2]               # (nf, N, 2)
        body_xy = torch.stack(p)[sample_bodies_t][..., :2]    # (nsb, N, 2)
        xy = torch.cat([body_xy, foot_xy], 0)
        xs, ys = xy[..., 0], xy[..., 1]
        h_s, n_s = hf.sample_with_normal(xs, ys)
        nrm = torch.stack(n_s)[:, geom_slot]
        return h_s[geom_slot], nrm, xs[geom_slot], ys[geom_slot]

    # box-corner sampling strategy, decided at build time from the terrain:
    # one centre tangent plane (slope-clamped) extrapolated to all corners
    # on smooth terrain, exact per-corner planes where cell-to-cell steps
    # exceed 0.15 m (stairs). Deltas >= 50 m are the arena-wall fencing
    # rows and are excluded.
    cell_step = 0.0
    if with_box:
        h_np = hf.height.detach().cpu().numpy()
        if h_np.size > 1:
            dh = np.concatenate([np.abs(np.diff(h_np, axis=0)).ravel(),
                                 np.abs(np.diff(h_np, axis=1)).ravel()])
            dh = dh[dh < 50.0]
            if dh.size:
                cell_step = float(dh.max())
    box_corner_exact = cell_step > 0.15

    def sample_box_terrain(box_q):
        """Tangent-plane cache under the box: (h (C, N), normal (3, C, N),
        ax, ay) with C = 8 corners on step terrain, else C = 1 centre."""
        if box_corner_exact:
            Rb = maths.quat_to_mat(box_q[:, 3:7])
            cw = (box_q[:, None, :3] + (Rb[:, None] @ box_corners[:, :, None]
                                        ).squeeze(-1)).permute(1, 0, 2)
            cx, cy = cw[..., 0], cw[..., 1]                   # (8, N)
        else:
            cx, cy = box_q[None, :, 0], box_q[None, :, 1]     # (1, N)
        h_c, n_c = hf.sample_with_normal(cx, cy)
        return h_c, torch.stack(n_c), cx, cy

    def box_coupling(gp, gv, share_f, cf, cf_new, bx, box_cache, friction):
        """Robot spheres vs the box OBB (two-way) and box corners vs the
        terrain; returns (force on the geoms (3, ng, N), box force (3, N),
        box torque (3, N))."""
        bq, bqd, m_box, _ = bx
        Rb = maths.quat_to_mat(bq[:, 3:7])
        pb = bq[:, :3].T[:, None, :]                          # (3, 1, N)
        vbl = bqd[:, :3].T[:, None, :]
        wb = bqd[:, 3:].T[:, None, :]

        d_loc = torch.einsum("nik,ign->kgn", Rb, gp - pb)
        cl = torch.maximum(torch.minimum(d_loc, bhe_col), -bhe_col)
        delta = d_loc - cl
        dist = torch.sqrt((delta * delta).sum(0) + 1e-12)
        n_w = torch.einsum("nki,ign->kgn", Rb, delta / dist)  # box -> geom
        phi_b = dist - radius_col
        act_b = (phi_b < 0.0) & (dist > 1e-5)
        r_box = torch.einsum("nki,ign->kgn", Rb, cl)          # cpt - pb
        vr = gv - (vbl + _cross0(wb.expand_as(r_box), r_box))
        vn_b = (vr * n_w).sum(0)
        m_eff = 1.0 / (1.0 / (share_f * m_dir(w6_col, n_w)) + 1.0 / m_box)
        push_b = torch.clamp(cp.baumgarte * torch.clamp(-phi_b - cp.slop,
                                                        min=0.0) / dt,
                             max=cp.max_depen_vel)
        fprev_b = cf["boxg"]
        fdn_b = (fprev_b * n_w).sum(0)
        fnp_b = cp.warm_decay * torch.clamp(fdn_b, min=0.0)
        ftp_b = (fprev_b - n_w * fdn_b) * cp.warm_decay
        fn_b = torch.clamp(fnp_b + cp.relax * m_eff * (push_b - vn_b) / dt,
                           0.0, cp.fn_max)
        fn_b = torch.where(act_b, fn_b, 0.0)
        vt_b = vr - n_w * vn_b
        tb_hat = vt_b / torch.sqrt((vt_b * vt_b).sum(0) + 1e-12)
        m_eff_t = 1.0 / (1.0 / (share_f * m_dir(w6_col, tb_hat)) + 1.0 / m_box)
        ftv_b = ftp_b + vt_b * (-cp.relax * m_eff_t / dt)
        ftn_b = torch.sqrt((ftv_b * ftv_b).sum(0) + 1e-12)
        fsc_b = torch.clamp(friction * fn_b / ftn_b, max=1.0)
        F_geom = torch.where(act_b, fn_b * n_w + ftv_b * fsc_b, 0.0)
        fn_bc = torch.minimum(fn_b, fnp_b + cp.warm_growth * 9.81 * m_eff)
        fsc_bc = torch.minimum(fsc_b, (friction * fn_bc) / ftn_b)
        cf_new["boxg"] = torch.where(act_b, fn_bc * n_w + ftv_b * fsc_bc, 0.0)
        box_F = -F_geom.sum(1)
        box_N = -_cross0(r_box, F_geom).sum(1)

        # box corners vs terrain (same law, mass shared among active corners)
        rc = torch.einsum("nij,cj->icn", Rb, box_corners)    # (3, 8, N)
        cw = pb + rc
        vc = vbl + _cross0(wb.expand_as(rc), rc)
        hb_a, n_c, bax, bay = box_cache
        # slope clamp |dh/dxy| <= 2: near cliffs extrapolating the plane
        # over the box diagonal is meaningless
        sx = torch.clamp(n_c[0] / n_c[2], -2.0, 2.0)
        sy = torch.clamp(n_c[1] / n_c[2], -2.0, 2.0)
        h_c = hb_a - sx * (cw[0] - bax) - sy * (cw[1] - bay)
        phi_c = (cw[2] - h_c) * n_c[2] - box_r
        act_c = phi_c < 0.0
        m_sh = m_box / torch.clamp(act_c.to(torch.float32).sum(0), min=1.0)
        vn_c = (vc * n_c).sum(0)
        push_c = torch.clamp(cp.baumgarte * torch.clamp(-phi_c - cp.slop,
                                                        min=0.0) / dt,
                             max=cp.max_depen_vel)
        fprev_c = cf["corner"]
        fdn_c = (fprev_c * n_c).sum(0)
        fnp_c = cp.warm_decay * torch.clamp(fdn_c, min=0.0)
        ftp_c = (fprev_c - n_c * fdn_c) * cp.warm_decay
        fn_cc = torch.clamp(fnp_c + cp.relax * m_sh * (push_c - vn_c) / dt,
                            0.0, cp.fn_max)
        fn_cc = torch.where(act_c, fn_cc, 0.0)
        vt_c = vc - n_c * vn_c
        ftv_c = ftp_c + vt_c * (-cp.relax * m_sh / dt)
        ftn_c = torch.sqrt((ftv_c * ftv_c).sum(0) + 1e-12)
        fsc_c = torch.clamp(friction * fn_cc / ftn_c, max=1.0)
        F_c = torch.where(act_c, fn_cc * n_c + ftv_c * fsc_c, 0.0)
        fn_ck = torch.minimum(fn_cc, fnp_c + cp.warm_growth * 9.81 * m_sh)
        fsc_ck = torch.minimum(fsc_c, (friction * fn_ck) / ftn_c)
        cf_new["corner"] = torch.where(act_c, fn_ck * n_c + ftv_c * fsc_ck,
                                       0.0)
        box_F = box_F + F_c.sum(1)
        box_N = box_N + _cross0(rc, F_c).sum(1)
        return F_geom, box_F, box_N

    def substep(q, qd, tau, IA_body, mass, com, cache, cf, friction, bx,
                box_cache):
        # ---------------- FK ----------------
        with spans.span("sim.fk"):
            R, p, v, jR, jp = fk(q, qd)

        # ---------------- terrain contact, (ng, N) layout ----------------
        with spans.span("sim.contact"):
            Rg, r_w, pg = geom_frames(R, p)
            vg = torch.stack(v)[gb]                           # (ng, N, 6)
            w_w = (Rg @ vg[..., :3, None]).squeeze(-1)
            u_w = (Rg @ vg[..., 3:, None]).squeeze(-1)
            gp = (pg + r_w).permute(2, 0, 1).contiguous()      # (3, ng, N)
            gv = (u_w + torch.linalg.cross(w_w, r_w)).permute(
                2, 0, 1).contiguous()
            gF, cf_terr, active, share_f = contact_law(
                gp, gv, cache, cf["terr"], friction, gc, cp, dt)
            cf_new = {"terr": cf_terr}

            if bx is not None:
                F_geom, box_F, box_N = box_coupling(
                    gp, gv, share_f, cf, cf_new, bx, box_cache, friction)
                gF = gF + F_geom

            # per-body world wrench [torque; force] at body origins
            torque_g = _cross0(r_w.permute(2, 0, 1), gF)
            bF = torch.matmul(E, gF).permute(2, 1, 0)          # (N, nb, 3)
            bN = torch.matmul(E, torque_g).permute(2, 1, 0)

        # ---------------- joint-space extra torques, ABA ----------------
        with spans.span("sim.aba"):
            qj, qdj = q[:, 7:], qd[:, 6:]
            below = torch.clamp(qj - dof_lo, max=0.0)
            above = torch.clamp(qj - dof_hi, min=0.0)
            t = -params.limit_kp * (below + above) * i_eff
            stop = i_eff * torch.abs(qdj) / dt
            mag = damping * torch.abs(qdj) + friction_j
            mag = mag + torch.where((below < 0) | (above > 0),
                                    params.limit_kd * torch.abs(qdj), 0.0)
            tau_eff = tau + (t - torch.sign(qdj) * torch.minimum(mag, stop))

            # ---------------- ABA ----------------
            Rs = torch.stack(R, 1)                         # (N, nb, 3, 3)
            Rst = Rs.transpose(-1, -2)
            vs = torch.stack(v, 1)                             # (N, nb, 6)
            fg_lin = _mv(Rst, gvec) * mass[..., None]
            f_bias = torch.cat(
                [torch.linalg.cross(com, fg_lin) + _mv(Rst, bN),
                 fg_lin + _mv(Rst, bF)], -1)
            pA = list((spatial.cross_force(vs, _mv(IA_body, vs))
                       - f_bias).unbind(1))
            qd_b = torch.cat([torch.zeros_like(qd[:, :1]), qdj], -1)  # (N, nb)
            c_vp = spatial.cross_motion(vs, S * qd_b[..., None]).unbind(1)
            IA = list(IA_body.unbind(1))

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
                Rj, pj = jR[i], jp[i]
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
            R0 = R[0]
            ang_acc_w = _mv(R0, a0[:, :3])
            lin_acc_w = _mv(R0, a0[:, 3:] + torch.linalg.cross(
                v[0][:, :3], v[0][:, 3:]))

        # ---------------- integrate (semi-implicit) ----------------
        with spans.span("sim.integrate"):
            # base velocity clamps bound a near-singular base solve's
            # damage to one recoverable-or-terminated step instead of an
            # inf->NaN cascade
            lin = torch.clamp(qd[:, 0:3] + lin_acc_w * dt, -mv, mv)
            ang = torch.clamp(qd[:, 3:6] + ang_acc_w * dt, -mv, mv)
            joints_v = torch.clamp(qdj + dt * qdd, -params.max_joint_vel,
                                   params.max_joint_vel)
            q_new = torch.cat([q[:, 0:3] + lin * dt,
                               _integrate_quat(q[:, 3:7], ang, dt),
                               qj + dt * joints_v], -1)
            qd_new = torch.cat([lin, ang, joints_v], -1)

            # -------------- box integration (Newton-Euler) --------------
            bx_new = None
            if bx is not None:
                bq, bqd, m_box, i_d = bx
                Rb = maths.quat_to_mat(bq[:, 3:7])
                I_w = (Rb * i_d[:, None, :]) @ Rb.transpose(-1, -2)
                wb = bqd[:, 3:]
                gyro = torch.linalg.cross(wb, _mv(I_w, wb))
                wd = _solve3(I_w, box_N.T - gyro)
                lin_acc = gvec + box_F.T * (1.0 / m_box)[:, None]
                b_lin = torch.clamp(bqd[:, :3] + lin_acc * dt, -mv, mv)
                b_ang = torch.clamp(wb + wd * dt, -mv, mv)
                bx_new = (torch.cat([bq[:, :3] + b_lin * dt,
                                     _integrate_quat(bq[:, 3:7], b_ang, dt)],
                                    -1),
                          torch.cat([b_lin, b_ang], -1), m_box, i_d)
        return q_new, qd_new, gF, cf_new, bx_new

    def step(q, qd, tau_fn, mass, com, inertia, friction, n_steps,
             tau_carry=None, box_q=None, box_qd=None, box_mass=None,
             box_i_diag=None, contact_carry=None):
        """q (N, nq), qd (N, nv); tau_fn(q, qd) -> (N, nj), or with
        `tau_carry` tau_fn(carry, q, qd) -> (carry, (N, nj)); mass (N, nb),
        com (N, nb, 3), inertia (N, nb, 3, 3), friction (N,). Returns the
        FusedOut, followed by the torque law's final carry when
        `tau_carry` was given and by (box_q, box_qd) with a box.

        contact_carry: warm-start dict from init_contact_carry / the
        previous FusedOut.contact_carry; None starts from zero forces."""
        N = q.shape[0]
        IA_body = spatial.spatial_inertia(mass, com, inertia)  # (N, nb, 6, 6)
        cache = sample_terrain(q)
        if with_box:
            bx = (box_q, box_qd, box_mass, box_i_diag)
            box_cache = sample_box_terrain(box_q)
        else:
            bx = box_cache = None
        if contact_carry is None:
            contact_carry = init_contact_carry(model, N, with_box, dev)
        # (N, rows, 3) -> (3, rows, N)
        cf = {k: v.permute(2, 1, 0).contiguous()
              for k, v in contact_carry.items()}
        for _ in range(n_steps):
            if tau_carry is None:
                tau = tau_fn(q, qd)
            else:
                tau_carry, tau = tau_fn(tau_carry, q, qd)
            q, qd, gF, cf, bx = substep(q, qd, tau, IA_body, mass, com, cache,
                                        cf, friction, bx, box_cache)
        gf_last = gF.permute(2, 1, 0)                          # (N, ng, 3)
        out = FusedOut(
            q=q, qd=qd, foot_forces=gf_last[:, foot_idx],
            body_forces=torch.einsum("bg,ngc->nbc", E, gf_last),
            torques=tau,
            contact_carry={k: v.permute(2, 1, 0).contiguous()
                           for k, v in cf.items()})
        ret = (out,) if tau_carry is None else (out, tau_carry)
        if with_box:
            ret += (bx[0], bx[1])
        return ret[0] if len(ret) == 1 else ret

    step.fk = fk
    return step
