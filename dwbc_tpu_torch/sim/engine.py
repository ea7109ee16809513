"""Simulation parameters and the build-time physics context.

Counterpart of dwbc_tpu/sim/engine.py (`SimParams`,
`geom_effective_masses`, `PhysCtx`, `build_ctx`, `BodyState`). The
context is build-time work: it runs once on the CPU in float32, and the
simulator moves its results to the device (sim/fused.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core import spatial as sp
from ..core.model import RobotModel
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
