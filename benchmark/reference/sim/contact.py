"""Compliant terrain contact over a static sphere set: the plain law.

Counterpart of dwbc_tpu/sim/contact.py. Every robot has a static list of
collision spheres, each tested against the terrain in O(1).

Two laws:
  * `fused_terrain_law`, the production law of the envs' substep: every
    array is (ng, N) with masked inactive contacts, against cached
    terrain tangent planes. It is the plain PyTorch version of the
    contact kernel (ops/contact_kernel.py + csrc/contact_law.cu): the CPU
    path, and the oracle the kernel is held against on the card.
  * `terrain_contact`, the per-env compliant law of the unfused step
    (sim/engine.py), batched over leading dims. The JAX package computes
    it outside any Pallas kernel, and here it is plain torch on any
    device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.model import RobotModel
from ..terrain.terrain import Heightfield
from .dynamics import Kin, _mv


class ContactParams(NamedTuple):
    """Impulse-style contact: each active contact applies the force that
    (given the contact's effective mass) removes its normal approach
    velocity within one dt plus a Baumgarte pushout of the penetration —
    one-iteration sequential impulses with a diagonal Delassus
    approximation. Restitution is 0 (legged_robot_config.py:195). See the
    JAX package's ContactParams for the stability reasoning behind each
    value."""

    baumgarte: float = 0.2   # fraction of penetration corrected per step
    max_depen_vel: float = 1.0  # pushout speed ceiling [m/s]
    warm_growth: float = 2.0  # carry growth limit, units of m_share*g
    warm_decay: float = 0.9   # carry decay per substep
    relax: float = 0.5        # under-relaxation of the impulse correction
    slop: float = 0.001       # penetration tolerance [m]
    fn_max: float = 2000.0    # per-contact force clamp [N]
    vel_eps: float = 1e-4     # tangential speed regularizer
    dt: float = 0.005         # must match SimParams.dt


class ContactOut(NamedTuple):
    geom_force: torch.Tensor   # (..., ng, 3) world force on each geom sphere
    body_wrench: torch.Tensor  # (..., nb, 6) world [torque; force] at body origins
    geom_pos: torch.Tensor     # (..., ng, 3) world sphere centers
    penetration: torch.Tensor  # (..., ng) signed distance (negative = contact)


def geom_world_state(model: RobotModel,
                     kin: Kin) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions and velocities (..., ng, 3) of all collision sphere
    centers."""
    dev = kin.pos.device
    gb = torch.as_tensor(model.geom_body, dtype=torch.long, device=dev)
    offs = torch.as_tensor(model.geom_pos, dtype=torch.float32, device=dev)
    R = kin.rot[..., gb, :, :]                   # (..., ng, 3, 3)
    origin = kin.pos[..., gb, :]
    p = origin + _mv(R, offs)
    # point velocity: world-frame v_origin + w x r
    vel = kin.vel[..., gb, :]
    w_w = _mv(R, vel[..., :3])
    v = _mv(R, vel[..., 3:]) + torch.linalg.cross(w_w, p - origin)
    return p, v


def terrain_contact(model: RobotModel, kin: Kin, hf: Heightfield, friction,
                    params: ContactParams, m_solo: torch.Tensor,
                    m_body: torch.Tensor) -> ContactOut:
    """World contact forces over any leading batch dims of `kin`.
    friction: a float or a per-env (...,) tensor; m_solo / m_body: (ng,)
    solo-contact and body-origin translational effective masses."""
    p, v = geom_world_state(model, kin)
    dev = p.device
    radius = torch.as_tensor(model.geom_radius, dtype=torch.float32,
                             device=dev)
    h = hf.sample(p[..., 0], p[..., 1])
    n = hf.normal(p[..., 0], p[..., 1])          # (..., ng, 3)
    phi = (p[..., 2] - h) * n[..., 2] - radius   # approx signed distance

    dt = params.dt
    vn = torch.sum(v * n, -1)
    active = phi < 0.0
    # split each body's effective mass among its simultaneously active
    # contacts (a resting box face has 4 corner contacts sharing one body;
    # solo-contact impulses would overshoot 4x and launch it)
    gb = torch.as_tensor(model.geom_body, dtype=torch.long, device=dev)
    batch = p.shape[:-2]
    per_body = torch.zeros(batch + (model.nb,), device=dev).index_add_(
        -1, gb, active.to(torch.float32))
    share = torch.clamp(per_body[..., gb], min=1.0)
    # min(solo, body/share): never exceed what the contact POINT can absorb
    m_share = torch.minimum(m_solo, m_body / share)
    # desired normal acceleration: cancel approach velocity + pushout
    push_v = torch.clamp(params.baumgarte * torch.clamp(-phi - params.slop,
                                                        min=0.0) / dt,
                         max=params.max_depen_vel)
    acc_n = (-vn) / dt + push_v / dt
    fn = torch.where(active, torch.clamp(m_share * acc_n, 0.0, params.fn_max),
                     0.0)

    vt = v - vn[..., None] * n
    vt_norm = torch.linalg.norm(vt, dim=-1)
    # stick impulse up to the friction cone
    mu = torch.as_tensor(friction, dtype=torch.float32, device=dev)[..., None]
    ft_mag = torch.minimum(mu * fn, m_share * vt_norm / dt)
    ft = -vt / (vt_norm + params.vel_eps)[..., None] * ft_mag[..., None]
    force = fn[..., None] * n + torch.where(active[..., None], ft, 0.0)

    # accumulate per-body wrench at body origins (world frame)
    torque = torch.linalg.cross(p - kin.pos[..., gb, :], force)
    zeros = torch.zeros(batch + (model.nb, 3), device=dev)
    wrench = torch.cat([zeros.index_add(-2, gb, torque),
                        zeros.index_add(-2, gb, force)], -1)
    return ContactOut(geom_force=force, body_wrench=wrench, geom_pos=p,
                      penetration=phi)


class GeomConst(NamedTuple):
    """Static per-geom constants of the law, on the law's device.

    radius, m_solo, m_body: (ng,) float32; w6: (6, ng) float32 Delassus
    components in the order xx, yy, zz, xy, xz, yz; geom_body: (ng,)
    int32 geom -> body index; nb: body count."""

    radius: torch.Tensor
    m_solo: torch.Tensor
    m_body: torch.Tensor
    w6: torch.Tensor
    geom_body: torch.Tensor
    nb: int


def _vdot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def m_dir(w6: torch.Tensor, d) -> torch.Tensor:
    """1/(d^T W d) for unit directions d (3 components broadcasting with
    (ng, N)); w6 is (6, ng, 1)-broadcastable."""
    q = (w6[0] * d[0] * d[0] + w6[1] * d[1] * d[1] + w6[2] * d[2] * d[2]
         + 2.0 * (w6[3] * d[0] * d[1] + w6[4] * d[0] * d[2]
                  + w6[5] * d[1] * d[2]))
    return 1.0 / torch.clamp(q, min=1e-6)


def fused_terrain_law(gp, gv, terrain_cache, fprev, friction,
                      gc: GeomConst, cp: ContactParams, dt: float):
    """Warm-started directional-Delassus contact impulses for a static
    sphere set against cached terrain tangent planes.

    gp, gv, fprev: (3, ng, N) world sphere positions / velocities /
      warm-start carry; terrain_cache: (h_anchor (ng, N), normal (3, ng, N),
      ax (ng, N), ay (ng, N)); friction: (N,) per-env Coulomb coefficient.
    Returns (gF, cf_new, active, share_f): applied world forces (3, ng, N),
    new carry (3, ng, N), the active mask (ng, N) bool and the multi-contact
    mass-share factor (ng, N)."""
    h_a, nrm, ax, ay = terrain_cache
    radius = gc.radius[:, None]
    m_solo = gc.m_solo[:, None]
    m_body = gc.m_body[:, None]
    w6 = gc.w6[:, :, None]

    # evaluate each geom's cached tangent plane at its current position
    dhdx = -nrm[0] / nrm[2]
    dhdy = -nrm[1] / nrm[2]
    h = h_a + dhdx * (gp[0] - ax) + dhdy * (gp[1] - ay)
    phi = (gp[2] - h) * nrm[2] - radius
    active = phi < 0.0

    # per-body active count -> shared effective mass. The count is a sum
    # of 0/1 values, exact in any order.
    gb = gc.geom_body.long()
    count_b = torch.zeros((gc.nb, active.shape[1]), dtype=torch.float32,
                          device=active.device)
    count_b.index_add_(0, gb, active.to(torch.float32))
    count_g = torch.clamp(count_b, min=1.0)[gb]
    m_share = torch.minimum(m_solo, m_body / count_g)
    share_f = m_share / m_solo

    vn = _vdot3(gv, nrm)
    push_v = torch.clamp(cp.baumgarte * torch.clamp(-phi - cp.slop, min=0.0)
                         / dt, max=cp.max_depen_vel)
    m_n = share_f * m_dir(w6, nrm)
    vt = [gv[k] - nrm[k] * vn for k in range(3)]
    vt_norm = torch.sqrt(_vdot3(vt, vt) + 1e-12)
    t_hat = [vt[k] / vt_norm for k in range(3)]
    m_t = share_f * m_dir(w6, t_hat)
    fdotn = _vdot3(fprev, nrm)
    fn_prev = cp.warm_decay * torch.clamp(fdotn, min=0.0)
    ftp = [(fprev[k] - nrm[k] * fdotn) * cp.warm_decay for k in range(3)]
    fn = torch.clamp(fn_prev + cp.relax * m_n * (push_v - vn) / dt,
                     0.0, cp.fn_max)
    fn = torch.where(active, fn, 0.0)
    ftv = [ftp[k] + vt[k] * (-cp.relax * m_t / dt) for k in range(3)]
    ft_norm = torch.sqrt(_vdot3(ftv, ftv) + 1e-12)
    fscale = torch.clamp(friction * fn / ft_norm, max=1.0)
    gF = torch.stack([torch.where(active, fn * nrm[k] + ftv[k] * fscale, 0.0)
                      for k in range(3)])
    # growth-clamped carry: static loads persist, impact spikes don't
    dF = cp.warm_growth * 9.81 * m_n
    fn_c = torch.minimum(fn, fn_prev + dF)
    fsc_c = torch.minimum(fscale, (friction * fn_c) / ft_norm)
    cf_new = torch.stack([torch.where(active, fn_c * nrm[k] + ftv[k] * fsc_c,
                                      0.0) for k in range(3)])
    return gF, cf_new, active, share_f
