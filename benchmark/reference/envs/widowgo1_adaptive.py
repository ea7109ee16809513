"""The widowGo1 variant with adaptive arm gains and the OSC
torque-supervision expert (widowGo1_config.py:162-173 flags), written
from the published equations on top of the plain reference's
WidowGo1Env.

  * Adaptive arm gains (widowGo1.py:1283-1288): the policy emits 24
    actions; the last 6 are per-env deltas of the arm's kp, so the arm
    drives with kp = max(kp + delta, 0) and kd = 2 sqrt(kp).
  * The OSC expert (widowGo1.py:1217-1242), computed from the state each
    env step starts from, before its physics:
        u = J^T Lambda (kp dpose - kd v_ee) + g(q)
    with J the gripper point's world jacobian restricted to the 6 arm
    dofs, dpose the position error to the yaw-rotated EE goal and the
    orientation error to the fixed gripper-down quaternion, v_ee the
    gripper's world [linear; angular] velocity, and g the arm's rows of
    the RNEA bias at zero velocity.

Departure from the original, as the program documents it: the original
inverts with a pseudo-inverse, which gives NaNs on an ill-conditioned
arm block. Here both inverses are damped Cholesky solves
(torch.linalg.cholesky_ex / cholesky_solve): M_arm + 1e-6 I, and
Lambda = (J M_arm^-1 J^T + 1e-4 I)^-1.

The step's `extras` hold the program's three keys: target_arm_torques
(the expert's (N, 6) torques), current_arm_dof_pos and
current_arm_dof_vel (the arm's q and qd the step started from).
"""

from __future__ import annotations

import torch

from ..core import maths
from ..sim import dynamics
from .widowgo1 import WidowGo1Env

# the arm's 6 dofs among the generalised velocities (base 6, legs 12)
ARM = slice(6 + 12, 6 + 18)
# the gripper pointing down: the OSC's fixed orientation target (x, y, z, w)
EE_ORN_DES = (0.0, 0.7071068, 0.0, 0.7071068)


def orientation_error(desired: torch.Tensor, current: torch.Tensor):
    """The vector part of desired * conj(current), signed by its real
    part (widowGo1.py:1223)."""
    q_r = maths.quat_mul(desired, maths.quat_conjugate(current))
    return q_r[..., :3] * torch.sign(q_r[..., 3:4])


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x = b for a batch of SPD matrices a (..., n, n), b (..., n, k),
    by a Cholesky factorisation that raises nothing and never waits for
    the device."""
    factor, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b, factor)


class WidowGo1AdaptiveEnv(WidowGo1Env):
    """WidowGo1Env with 24 actions, adaptive arm gains and the OSC
    expert's targets in every step's extras."""

    def __init__(self, cfg, num_envs: int = 64, seed: int = 1,
                 device="cuda"):
        super().__init__(cfg, num_envs=num_envs, seed=seed, device=device)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32,
                                     device=self.device)
        self.osc_kp = f32(cfg.arm.osc_kp)
        self.osc_kd = f32(cfg.arm.osc_kd)
        self.ee_orn_des = f32(EE_ORN_DES)

    # -- the torque law ----------------------------------------------------

    def _pd_torques(self, actions, dof_pos, dof_vel, motor_strength):
        """PD torques on the 18 actuated dofs + zero gripper torques, the
        arm's gains adapted per env by the trailing 6 actions."""
        scaled = actions[:, :18] * motor_strength * self.action_scale
        target = scaled + self.default_dof_pos[None, :18]
        arm_p = torch.clamp(self.p_gains[12:] + actions[:, 18:24], min=0.0)
        arm_d = self._arm_damping(arm_p)
        n = actions.shape[0]
        p_g = torch.cat([self.p_gains[:12].expand(n, 12), arm_p], -1)
        d_g = torch.cat([self.d_gains[:12].expand(n, 12), arm_d], -1)
        tau = p_g * (target - dof_pos) - d_g * dof_vel
        tau20 = torch.cat([tau, torch.zeros_like(tau[:, :2])], -1)
        return torch.clamp(tau20, -self.torque_limits, self.torque_limits)

    @staticmethod
    def _arm_damping(arm_p: torch.Tensor) -> torch.Tensor:
        """Critical damping of a unit inertia: kd = 2 sqrt(kp)."""
        return 2.0 * torch.sqrt(arm_p)

    # -- the OSC expert ------------------------------------------------------

    def _osc_wrench_torques(self, state) -> torch.Tensor:
        """J^T Lambda (kp dpose - kd v_ee), (N, 6)."""
        m = self.model
        q, qd = state.robot.q, state.robot.qd
        kin = dynamics.fk(m, q, qd)
        jac = dynamics.body_jacobian(m, q, self.gripper_body, self.ee_offset,
                                     kin=kin)[:, :, ARM]
        jac_t = jac.transpose(-1, -2)
        eye6 = torch.eye(6, device=self.device)
        m_arm = dynamics.crba(m, state.inert, q)[:, ARM, ARM]
        m_inv_jt = spd_solve(m_arm + 1e-6 * eye6, jac_t)
        task_inv = jac @ m_inv_jt + 1e-4 * eye6

        rot = kin.rot[:, self.gripper_body]
        r_off = rot @ self.ee_offset
        ee_pos = kin.pos[:, self.gripper_body] + r_off
        vel = kin.vel[:, self.gripper_body]            # [ang; lin], body
        w_w = (rot @ vel[:, :3, None])[..., 0]
        v_w = (rot @ vel[:, 3:, None])[..., 0] + torch.linalg.cross(w_w,
                                                                    r_off)
        ee_vel = torch.cat([v_w, w_w], -1)

        base = torch.cat([q[:, 0:2], torch.full_like(
            q[:, :1], self.z_invariant_offset)], -1)
        goal = base + maths.quat_rotate(maths.yaw_quat(q[:, 3:7]),
                                        state.curr_ee_goal_cart)
        orn = maths.normalize(maths.mat_to_quat(rot))
        dpose = torch.cat([goal - ee_pos,
                           orientation_error(self.ee_orn_des, orn)], -1)
        wrench = spd_solve(task_inv, (self.osc_kp * dpose
                                      - self.osc_kd * ee_vel)[..., None])
        return (jac_t @ wrench)[..., 0]

    def _osc_gravity(self, state) -> torch.Tensor:
        """g(q): the arm's rows of the RNEA bias at zero velocity, (N, 6)."""
        q, qd = state.robot.q, state.robot.qd
        bias = dynamics.rnea_bias(self.model, state.inert, q,
                                  torch.zeros_like(qd))
        return bias[:, ARM]

    def _osc_target(self, state) -> torch.Tensor:
        return self._osc_wrench_torques(state) + self._osc_gravity(state)

    # -- the step ------------------------------------------------------------

    def step(self, state, actions: torch.Tensor, counter: float):
        """WidowGo1Env's step, its extras the expert's target and the arm
        state from the state the step starts from (widowGo1.py:1178-1182:
        at substep 0, before the physics; the action delay buffer, which
        the parent's step updates first, enters none of them)."""
        extras = {
            "target_arm_torques": self._osc_target(state),
            "current_arm_dof_pos": state.robot.q[:, 7 + 12:7 + 18],
            "current_arm_dof_vel": state.robot.qd[:, ARM],
        }
        state, out = super().step(state, actions, counter)
        return state, out._replace(extras=extras)
