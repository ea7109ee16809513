"""Simulation parameters, the build-time physics context and the unfused
batched substep.

Counterpart of dwbc_tpu/sim/engine.py. The context (`build_ctx`) is
build-time work: it runs once on the CPU in float32, and the simulator
moves its results to the device. `physics_substep` is the unfused step
(FK -> per-env compliant contact -> ABA -> integration) on (N, ...)
tensors; `make_batched_step` is the counterpart of the JAX package's
vmap of it. The envs step through sim/fused.py instead; this step serves
physics checks and scenes that are not envs. It is plain torch on any
device: the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import maths
from ..core import spatial as sp
from ..core.model import RobotModel
from ..terrain.terrain import Heightfield
from . import contact as contact_mod
from . import dynamics
from .contact import ContactParams


class SimParams(NamedTuple):
    dt: float = 0.005               # physics dt (legged_robot_config.py:183)
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact: ContactParams = ContactParams()
    limit_kp: float = 10000.0       # joint-limit stiffness [1/s^2] (inertia-relative)
    limit_kd: float = 5.0
    max_joint_vel: float = 50.0     # hard safety clamp
    max_base_vel: float = 50.0      # base lin/ang velocity clamp


def _point_jacobian(model: RobotModel, kin: dynamics.Kin, body: int,
                    p_point: torch.Tensor) -> torch.Tensor:
    """(3, nv) translational jacobian of a world point welded to `body`,
    base block in base-body spatial coords [ang; lin] (CRBA's layout)."""
    J = torch.zeros((3, model.nv))
    R0 = kin.rot[0]
    r_b = R0.T @ (p_point - kin.pos[0])
    J[:, 0:3] = -R0 @ sp.skew(r_b)
    J[:, 3:6] = R0
    i = body
    while i > 0:
        ax_w = kin.rot[i] @ torch.as_tensor(model.joint_axis[i])
        if int(model.joint_type[i]) == 0:
            J[:, 6 + i - 1] = torch.linalg.cross(ax_w, p_point - kin.pos[i])
        else:
            J[:, 6 + i - 1] = ax_w
        i = int(model.parent[i])
    return J


def geom_effective_masses(model: RobotModel, q_ref: torch.Tensor):
    """Per-geom contact effective masses at a reference pose: (m_solo,
    m_body, w_geom). m_solo = 1/(n^T J M^-1 J^T n) along the vertical at
    the sphere centre; m_body the same at the body origin; w_geom the full
    3x3 translational Delassus matrix J M^-1 J^T at the sphere centre."""
    # build-time work on the CPU by design (module docstring)
    M = dynamics.crba(model, dynamics.default_inertial(model, "cpu"), q_ref)
    Minv = torch.linalg.inv(M + 1e-9 * torch.eye(model.nv))
    kin = dynamics.fk(model, q_ref, torch.zeros(model.nv))
    n = torch.tensor([0.0, 0.0, 1.0])

    def m_eff(J):
        Jn = n @ J
        return 1.0 / (Jn @ Minv @ Jn + 1e-9)

    m_solo, m_body, w_geom = [], [], []
    for gi in range(len(model.geom_body)):
        body = int(model.geom_body[gi])
        offset = torch.as_tensor(model.geom_pos[gi])
        p_point = kin.pos[body] + kin.rot[body] @ offset
        J = _point_jacobian(model, kin, body, p_point)
        m_solo.append(m_eff(J))
        m_body.append(m_eff(_point_jacobian(model, kin, body, kin.pos[body])))
        w_geom.append(J @ Minv @ J.T)
    return torch.stack(m_solo), torch.stack(m_body), torch.stack(w_geom)


class PhysCtx(NamedTuple):
    """Static per-model physics context precomputed at a reference pose
    (CPU float32 tensors)."""

    m_solo: torch.Tensor     # (ng,) solo-contact effective masses (vertical)
    m_body: torch.Tensor     # (ng,) translational effective mass at body origin
    dof_i_eff: torch.Tensor  # (nj,) joint effective inertias (diag of CRBA M)
    w_geom: torch.Tensor     # (ng, 3, 3) translational Delassus


def build_ctx(model: RobotModel, q_ref: torch.Tensor) -> PhysCtx:
    q_ref = torch.as_tensor(q_ref, dtype=torch.float32, device="cpu")
    M = dynamics.crba(model, dynamics.default_inertial(model, "cpu"), q_ref)
    m_solo, m_body, w_geom = geom_effective_masses(model, q_ref)
    return PhysCtx(m_solo=m_solo, m_body=m_body,
                   dof_i_eff=torch.diagonal(M)[6:], w_geom=w_geom)


@dataclasses.dataclass
class BodyState:
    """State of one articulation batched over envs: q = [pos, quat,
    joints], qd = [lin vel world, ang vel world, joint vels]."""

    q: torch.Tensor
    qd: torch.Tensor


def _limit_torques(model: RobotModel, q: torch.Tensor, qd: torch.Tensor,
                   params: SimParams, dof_i_eff: torch.Tensor) -> torch.Tensor:
    """Penalty enforcement of URDF joint position limits + joint damping
    and dry friction, (..., nj). Every velocity-opposing term is clamped
    so that it can at most remove the joint's current velocity in one dt
    given its effective inertia (the gripper's dry friction of 1000 then
    acts as a clean lock instead of an oscillator)."""
    dev = q.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    qj, qdj = q[..., 7:], qd[..., 6:]
    below = torch.clamp(qj - f32(model.dof_lower), max=0.0)
    above = torch.clamp(qj - f32(model.dof_upper), min=0.0)
    tau = -params.limit_kp * (below + above) * dof_i_eff

    # velocity-opposing magnitude: damping + dry friction + limit damping
    stop = dof_i_eff * torch.abs(qdj) / params.dt  # torque that zeroes qd
    mag = f32(model.dof_damping) * torch.abs(qdj) + f32(model.dof_friction)
    mag = mag + torch.where((below < 0) | (above > 0),
                            params.limit_kd * torch.abs(qdj), 0.0)
    return tau - torch.sign(qdj) * torch.minimum(mag, stop)


def _integrate(q: torch.Tensor, qd: torch.Tensor, qdd: torch.Tensor,
               dt: float, max_joint_vel: float):
    """Semi-implicit Euler with quaternion exponential update."""
    qd = qd + dt * qdd
    qd = torch.cat([torch.clamp(qd[..., :6], -50.0, 50.0),
                    torch.clamp(qd[..., 6:], -max_joint_vel, max_joint_vel)],
                   -1)
    pos = q[..., 0:3] + dt * qd[..., 0:3]
    quat = maths.quat_integrate(q[..., 3:7], qd[..., 3:6], dt)
    joints = q[..., 7:] + dt * qd[..., 6:]
    return torch.cat([pos, quat, joints], -1), qd


def _ctx_on(ctx: PhysCtx, device) -> PhysCtx:
    return PhysCtx(*(t.to(device) for t in ctx))


def physics_substep(model: RobotModel, params: SimParams, hf: Heightfield,
                    inert: dynamics.Inertial, friction, state: BodyState,
                    tau: torch.Tensor, ctx: PhysCtx,
                    f_ext_world: Optional[torch.Tensor] = None):
    """One physics dt: contact -> ABA -> integrate, over the leading batch
    dims of state.q (N envs, or none for one). friction: a float or (N,)
    per env; inert: Inertial, shared or with the leading (N,) axis.
    Returns (BodyState, ContactOut)."""
    ctx = _ctx_on(ctx, state.q.device)
    kin = dynamics.fk(model, state.q, state.qd)
    con = contact_mod.terrain_contact(model, kin, hf, friction,
                                      params.contact, ctx.m_solo, ctx.m_body)
    wrench = con.body_wrench
    if f_ext_world is not None:
        wrench = wrench + f_ext_world
    tau_eff = tau + _limit_torques(model, state.q, state.qd, params,
                                   ctx.dof_i_eff)
    qdd, _ = dynamics.aba(model, inert, state.q, state.qd, tau_eff,
                          f_ext_world=wrench, gravity=params.gravity, kin=kin)
    q, qd = _integrate(state.q, state.qd, qdd, params.dt,
                       params.max_joint_vel)
    return BodyState(q=q, qd=qd), con


def make_batched_step(model: RobotModel, params: SimParams, hf: Heightfield,
                      q_ref):
    """Returns step(state, tau, inert, friction) over envs: state.q (N, nq),
    tau (N, nj), friction (N,), inert an Inertial with the leading (N,)
    axis. The effective masses are computed once at the reference pose
    q_ref (the standing pose) and kept on the heightfield's device."""
    ctx = _ctx_on(build_ctx(model, q_ref), hf.height.device)

    def step(state: BodyState, tau, inert, friction):
        return physics_substep(model, params, hf, inert, friction, state, tau,
                               ctx)

    return step
