"""WidowGo1 whole-body loco-manipulation environment on torch tensors.

Counterpart of dwbc_tpu/envs/widowgo1.py: the same task semantics —
decimation-4 PD torque loop, action delay buffer, EE-goal spherical
trajectories with rejection-sampled collision checks, dual leg/arm
rewards (÷100, not dt-scaled — widowGo1.py:127-133, 189, 205),
goal-conditioned termination, command/reward curricula, domain
randomization, obs history — as `step(state, actions, counter)` over an
explicit `EnvState` of tensors. Random draws come from the
`torch.Generator` the state carries (the JAX package threads a PRNG key
instead, so the two packages draw different numbers from one seed).

The variants are ported too: adaptive arm gains (24 actions, the last 6
arm kp deltas), the OSC torque-supervision target in `StepOut.extras`,
the opt-in gravity-droop compensation and terrain-relative spawn, and the
terminal reward-scale curricula of a schedule-restarted resume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import maths, urdf
from ..core.model import free_body_model
from ..sim import dynamics, engine, fused
from ..sim.contact import ContactParams
from ..terrain import terrain as terr
from ..utils import device as device_lib
from ..utils import spans
from ..utils.device import resolve_device
from .config import WidowGo1Cfg


@dataclasses.dataclass
class EnvState:
    # physics
    robot: engine.BodyState          # q (N, 27), qd (N, 26)
    box: engine.BodyState            # q (N, 7), qd (N, 6)
    # episode bookkeeping
    episode_length: torch.Tensor     # (N,) int32
    common_step: int                 # policy steps since the batch was built
    generator: torch.Generator       # the env's random stream
    # control buffers
    actions: torch.Tensor            # (N, num_actions) delayed actions in effect
    last_actions: torch.Tensor       # (N, num_actions)
    last_dof_vel: torch.Tensor       # (N, 20)
    action_history: torch.Tensor     # (N, delay+2, num_actions)
    obs_history: torch.Tensor        # (N, hist, num_proprio)
    torques: torch.Tensor            # (N, 20) last applied torques
    # commands & EE goals
    commands: torch.Tensor           # (N, 3) [vx, vy(=0), wyaw]
    traj_timesteps: torch.Tensor     # (N,)
    traj_total_timesteps: torch.Tensor  # (N,)
    goal_timer: torch.Tensor         # (N,)
    ee_start_sphere: torch.Tensor    # (N, 3)
    ee_goal_sphere: torch.Tensor     # (N, 3)
    ee_goal_delta_orn_euler: torch.Tensor  # (N, 3)
    ee_goal_orn_euler: torch.Tensor  # (N, 3)
    curr_ee_goal_sphere: torch.Tensor  # (N, 3)
    curr_ee_goal_cart: torch.Tensor  # (N, 3)
    # domain randomization (drawn at env build)
    friction: torch.Tensor           # (N,)
    motor_strength: torch.Tensor     # (N, 18)
    mass_params: torch.Tensor        # (N, 5) [base dm, dcom xyz, gripper dm]
    inert: dynamics.Inertial         # batched (N, nb, ...)
    box_inert: dynamics.Inertial
    env_origins: torch.Tensor        # (N, 3)
    box_delta_y: torch.Tensor        # (N,)
    # sensors (filled post-step)
    foot_forces: torch.Tensor        # (N, 4, 3) world force per foot
    body_forces: torch.Tensor        # (N, nb, 3) net contact force per body
    contact_carry: Dict[str, torch.Tensor]  # warm-start contact forces
    feet_air_time: torch.Tensor      # (N, 4)
    last_contacts: torch.Tensor      # (N, 4) bool
    episode_reward: torch.Tensor     # (N,) cumulative leg reward
    episode_arm_reward: torch.Tensor  # (N,) cumulative arm reward
    episode_sums: Dict[str, torch.Tensor]
    metric_sums: Dict[str, torch.Tensor]
    reset_buf: torch.Tensor          # (N,) bool
    time_out_buf: torch.Tensor       # (N,) bool


class StepOut(NamedTuple):
    obs: torch.Tensor          # (N, 860)
    rew: torch.Tensor          # (N,)
    arm_rew: torch.Tensor      # (N,)
    reset: torch.Tensor        # (N,) bool
    time_outs: torch.Tensor    # (N,) bool
    # scalar diagnostics aggregated over envs that reset this step
    episode_stats: Dict[str, torch.Tensor]
    num_resets: torch.Tensor
    extras: Dict[str, torch.Tensor]


def _replace(state: EnvState, **kw) -> EnvState:
    return dataclasses.replace(state, **kw)


def _lerp_sched(counter, sched, init, final):
    """Schedule interpolation in float32, as the reference computes it."""
    f32 = np.float32
    t = np.clip((f32(counter) - f32(sched[0]))
                / max(f32(sched[1]) - f32(sched[0]), f32(1e-9)), 0.0, 1.0)
    init = np.asarray(init, f32)
    return init + f32(t) * (np.asarray(final, f32) - init)


class WidowGo1Env:
    """Static env data + step/reset over an EnvState (vectorized over N)."""

    def __init__(self, cfg: WidowGo1Cfg = WidowGo1Cfg(), num_envs: int = 64,
                 seed: int = 1, device="cuda"):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.num_envs = num_envs
        self.model = m = urdf.load_urdf(
            urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
            armature=cfg.sim.armature)
        bs = cfg.box.box_size
        self.box_model = free_body_model("box", cfg.box.density * bs ** 3,
                                         (bs / 2,) * 3)

        if cfg.terrain.mesh_type == "perlin":
            self.hf = terr.perlin_terrain(terr.PerlinTerrainCfg(
                horizontal_scale=cfg.terrain.horizontal_scale,
                tot_cols=cfg.terrain.tot_cols, tot_rows=cfg.terrain.tot_rows,
                z_scale=cfg.terrain.z_scale, seed=seed), device=dev)
        else:
            self.hf = terr.flat_plane(60.0, 1.0, device=dev)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.default_dof_pos = f32(cfg.init_state.default_joint_angles)
        q_ref = torch.zeros(m.nq)
        q_ref[6] = 1.0
        q_ref[2] = cfg.init_state.pos[2]
        q_ref[7:] = torch.as_tensor(cfg.init_state.default_joint_angles)
        self._q_ref = q_ref
        self.ctx = engine.build_ctx(m, q_ref)
        self.sim_params = engine.SimParams(
            dt=cfg.sim.dt, contact=ContactParams(dt=cfg.sim.dt))

        self.p_gains = f32(cfg.control.stiffness)        # (18,)
        self.d_gains = f32(cfg.control.damping)
        # opt-in gravity-droop compensation (default off = reference
        # parity), see enable_droop_compensation
        self.droop_comp = torch.zeros(18, device=dev)
        # opt-in terrain-relative spawn at ground + 0.40 m instead of the
        # reference's absolute 0.42 m (see _reset_envs). The JAX package
        # guards this flag and droop_comp against changes after its step
        # has been traced, because it jits `step` with the env static;
        # there is no trace here, so a flag set later simply takes effect
        # from the next step or reset.
        self.spawn_relative = False
        self.action_scale = f32(cfg.control.action_scale)
        self.torque_limits = f32(m.dof_effort)            # (20,)
        self.dof_lower = f32(m.dof_lower)
        self.dof_upper = f32(m.dof_upper)
        self.dt = cfg.dt
        self.max_episode_length = cfg.max_episode_length
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s
                                         / self.dt))

        # body/site indices
        self.gripper_body = m.sites["wx250s/ee_gripper_link"].body
        self.ee_offset = f32(m.sites["wx250s/ee_gripper_link"].pos)
        self.feet_geoms = np.concatenate([m.geoms_of(f)
                                          for f in urdf.FEET_ORDER])
        # foot force-sensor frames: the reference's sensors sit on the foot
        # links, merged into the calves here (no rotation), so the sensor
        # frame is the calf body frame (widowGo1.py:311-316, 1456)
        self.feet_bodies = [int(b) for b in
                            np.asarray(m.geom_body)[self.feet_geoms]]

        def bodies_matching(substrs):
            idx = [i for i, bn in enumerate(m.body_names)
                   if any(s in bn for s in substrs)]
            idx += [site.body for name, site in m.sites.items()
                    if any(s in name for s in substrs)]
            return torch.as_tensor(np.unique(np.asarray(idx, np.int64)),
                                   device=dev)

        self.penalized_bodies = bodies_matching(cfg.asset.penalize_contacts_on)
        self.termination_bodies = bodies_matching(
            cfg.asset.terminate_after_contacts_on)

        # the box actor is co-simulated inside the same substep with
        # two-way robot contact (reference widowGo1.py:320-325, 378-392)
        self.fused_step = fused.make_fused_substep(
            m, self.sim_params, self.hf, self.ctx, self.feet_geoms,
            device=dev, box_half_extents=(bs / 2,) * 3)
        if cfg.control.droop_compensation:
            self.enable_droop_compensation()
        self.osc_kp = f32(cfg.arm.osc_kp)
        self.osc_kd = f32(cfg.arm.osc_kd)
        self.z_invariant_offset = 0.53   # widowGo1.py:597
        self.sphere_error_scale = f32(cfg.goal_ee.sphere_error_scale)
        self.orn_error_scale = f32(cfg.goal_ee.orn_error_scale)
        self.collision_lower = f32(cfg.goal_ee.collision_lower_limits)
        self.collision_upper = f32(cfg.goal_ee.collision_upper_limits)

        self.reward_names = [k for k, v in vars(cfg.rewards.scales).items()
                             if v != 0]
        self.arm_reward_names = [k for k, v in
                                 vars(cfg.rewards.arm_scales).items() if v != 0]
        self.metric_names = [
            "leg_energy_abs_sum", "tracking_lin_vel_x_l1",
            "tracking_ang_vel_yaw_exp", "tracking_ee_cart",
            "tracking_ee_sphere", "tracking_ee_orn", "leg_action_l2",
            "torque", "energy_square", "foot_contacts_z",
        ]
        self.num_obs = cfg.env.num_observations
        self.num_actions = cfg.env.num_actions
        self.num_proprio = cfg.env.num_proprio
        self.num_priv = cfg.env.num_priv
        # x coordinate where the +1e5 fence wall begins (terrain.py:49):
        # spawns must stay clear of the wall's bilinear skirt
        half_col = cfg.terrain.tot_cols * cfg.terrain.horizontal_scale / 2
        self._wall_x = ((cfg.terrain.tot_cols // 2 - 100)
                        * cfg.terrain.horizontal_scale - half_col - 0.5
                        if cfg.terrain.mesh_type == "perlin" else float("inf"))

    # ------------------------------------------------------------------
    # curriculum (mirrors widowGo1.py:675-692)

    # When True, the two REWARD-SCALE curricula (tracking_ee,
    # tracking_ang_vel_yaw_exp) are pinned at their terminal values while
    # the range curricula still follow the counter. Used by schedule-
    # restarted resumes: replaying the reward-scale ramp on a policy whose
    # value function already prices the terminal arm reward re-creates a
    # net-negative-life trap.
    terminal_reward_scales = False

    def curriculum(self, counter: float):
        c = self.cfg.commands
        g = self.cfg.goal_ee
        scale_cnt = float("inf") if self.terminal_reward_scales else counter
        return dict(
            lin_vel_x=_lerp_sched(counter, c.lin_vel_x_schedule,
                                  c.init_lin_vel_x, c.final_lin_vel_x),
            ang_vel_yaw=_lerp_sched(counter, c.ang_vel_yaw_schedule,
                                    c.init_ang_vel_yaw, c.final_ang_vel_yaw),
            tracking_ang_vel_yaw_exp=_lerp_sched(
                scale_cnt, c.tracking_ang_vel_yaw_schedule, 0.0,
                c.final_tracking_ang_vel_yaw_exp),
            goal_ee_l=_lerp_sched(counter, g.l_schedule, g.init_pos_l,
                                  g.final_pos_l),
            goal_ee_p=_lerp_sched(counter, g.p_schedule, g.init_pos_p,
                                  g.final_pos_p),
            goal_ee_y=_lerp_sched(counter, g.y_schedule, g.init_pos_y,
                                  g.final_pos_y),
            tracking_ee=_lerp_sched(scale_cnt, g.tracking_ee_reward_schedule,
                                    0.0, g.final_tracking_ee_reward),
        )

    # ------------------------------------------------------------------
    # sampling helpers (vectorized over a boolean mask of envs)

    def _uniform(self, gen, shape, lo, hi):
        return maths.uniform(gen, shape, float(lo), float(hi), self.device)

    def _sample_commands(self, gen, n, curr):
        """(n, 3) velocity commands with small-command clipping
        (widowGo1.py:831-843)."""
        vx = self._uniform(gen, (n,), *curr["lin_vel_x"])
        wz = self._uniform(gen, (n,), *curr["ang_vel_yaw"])
        cmd = torch.stack([vx, torch.zeros_like(vx), wz], -1)
        keep = ((vx > self.cfg.commands.lin_vel_x_clip)
                | (torch.abs(wz) > self.cfg.commands.ang_vel_yaw_clip))
        return cmd * keep[:, None]

    def _collision_check(self, start_sphere, goal_sphere):
        """True = trajectory collides with the body AABB or underground
        (widowGo1.py:1337-1342)."""
        ns = self.cfg.goal_ee.num_collision_check_samples
        t = torch.linspace(0.0, 1.0, ns, device=self.device)[None, :, None]
        traj = start_sphere[:, None, :] * (1 - t) + goal_sphere[:, None, :] * t
        cart = maths.sphere2cart(traj)
        in_box = torch.any(torch.all(cart < self.collision_upper, -1)
                           & torch.all(cart > self.collision_lower, -1), dim=1)
        underground = torch.any(
            cart[..., 2] < self.cfg.goal_ee.underground_limit, dim=1)
        return in_box | underground

    def _resample_ee_goal(self, gen, state: EnvState, mask, curr,
                          base_yaw_euler) -> EnvState:
        """Masked rejection-sampled EE goal resample (widowGo1.py:1316-1335):
        up to 10 attempts per env against the collision AABB."""
        g = self.cfg.goal_ee
        N = self.num_envs
        device_lib.host_sync(self.device, 2)   # the bounds' two copies
        lo = torch.as_tensor([r[0] for r in g.final_delta_orn],
                             dtype=torch.float32, device=self.device)
        hi = torch.as_tensor([r[1] for r in g.final_delta_orn],
                             dtype=torch.float32, device=self.device)
        delta_orn = maths.uniform(gen, (N, 3), lo, hi, self.device)
        goal_orn = maths.wrap_to_pi(delta_orn + base_yaw_euler)

        start = state.ee_goal_sphere  # previous goal becomes the new start
        goal = state.ee_goal_sphere
        need = mask
        for i in range(10):
            cand = torch.stack([
                self._uniform(gen, (N,), *curr["goal_ee_l"]),
                self._uniform(gen, (N,), *curr["goal_ee_p"]),
                self._uniform(gen, (N,), *curr["goal_ee_y"]),
            ], -1)
            collides = self._collision_check(start, cand)
            goal = torch.where((need & ~collides)[:, None], cand, goal)
            if i == 9:  # keep the last attempt
                goal = torch.where((need & collides)[:, None], cand, goal)
            need = need & collides

        m3 = mask[:, None]
        return _replace(
            state,
            ee_start_sphere=torch.where(m3, start, state.ee_start_sphere),
            ee_goal_sphere=torch.where(m3, goal, state.ee_goal_sphere),
            ee_goal_delta_orn_euler=torch.where(
                m3, delta_orn, state.ee_goal_delta_orn_euler),
            ee_goal_orn_euler=torch.where(m3, goal_orn,
                                          state.ee_goal_orn_euler),
            goal_timer=torch.where(mask, 0.0, state.goal_timer),
        )

    # ------------------------------------------------------------------
    # build / reset

    def init_state(self, gen: torch.Generator) -> EnvState:
        """Build the full env batch: domain randomization, origins, first
        reset. Mirrors _create_envs + _init_buffers + reset()."""
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        dr = cfg.domain_rand
        U = self._uniform

        # env origins on the perlin strip (widowGo1.py:207-228)
        half_col = cfg.terrain.tot_cols * cfg.terrain.horizontal_scale / 2
        half_row = cfg.terrain.tot_rows * cfg.terrain.horizontal_scale / 2
        if cfg.terrain.mesh_type == "perlin":
            x = U(gen, (N,), -2.5 * half_col / 5, -2.0 * half_col / 5)
            y = U(gen, (N,), -half_row + 10, half_row - 10)
        else:
            side = int(np.ceil(np.sqrt(N)))
            yy, xx = np.meshgrid(np.arange(side), np.arange(side),
                                 indexing="ij")
            x = torch.as_tensor(3.0 * xx.flatten()[:N], dtype=torch.float32,
                                device=dev)
            y = torch.as_tensor(3.0 * yy.flatten()[:N], dtype=torch.float32,
                                device=dev)
        origins = torch.stack([x, y, torch.zeros_like(x)], -1)

        box_delta_y = (maths.rand_sign(gen, (N,), dev)
                       * U(gen, (N,), *cfg.box.box_env_origins_y_range))

        # friction buckets (widowGo1.py:480-496)
        buckets = U(gen, (dr.friction_buckets,), *dr.friction_range)
        bucket_ids = torch.randint(0, dr.friction_buckets, (N,),
                                   generator=gen, device=dev)
        friction = (buckets[bucket_ids] if dr.randomize_friction
                    else torch.ones(N, device=dev))

        # motor strength (widowGo1.py:402-408)
        if dr.randomize_motor:
            motor_strength = torch.cat([
                U(gen, (N, 12), *dr.leg_motor_strength_range),
                U(gen, (N, 6), *dr.arm_motor_strength_range)], -1)
        else:
            motor_strength = torch.ones((N, 18), device=dev)

        # mass params [base dm, dcom xyz, gripper dm] (widowGo1.py:431-456)
        dm = U(gen, (N,), *dr.added_mass_range) * dr.randomize_base_mass
        dcom = torch.stack([U(gen, (N,), *dr.added_com_range_x),
                            U(gen, (N,), *dr.added_com_range_y),
                            U(gen, (N,), *dr.added_com_range_z)],
                           -1) * dr.randomize_base_com
        dgrip = (U(gen, (N,), *dr.gripper_added_mass_range)
                 * dr.randomize_gripper_mass)
        mass_params = torch.cat([dm[:, None], dcom, dgrip[:, None]], -1)

        base = dynamics.default_inertial(m, dev)
        mass = base.mass[None].repeat(N, 1)
        com = base.com[None].repeat(N, 1, 1)
        inertia = base.inertia[None].repeat(N, 1, 1, 1)
        new_base_mass = mass[:, 0] + dm
        # shifted com: weighted blend keeps the first moment consistent
        com[:, 0] = ((com[:, 0] * mass[:, 0:1] + (com[:, 0] + dcom) * dm[:, None])
                     / new_base_mass[:, None])
        mass[:, 0] = new_base_mass
        mass[:, self.gripper_body] += dgrip
        inert = dynamics.Inertial(mass=mass, com=com, inertia=inertia)

        box_base = dynamics.default_inertial(self.box_model, dev)
        bdm = U(gen, (N,), *cfg.box.added_mass_range) * cfg.box.randomize_base_mass
        box_inert = dynamics.Inertial(
            mass=box_base.mass[None].repeat(N, 1) + bdm[:, None],
            com=box_base.com[None].repeat(N, 1, 1),
            inertia=box_base.inertia[None].repeat(N, 1, 1, 1))

        # per-env trajectory durations (sampled once, widowGo1.py:574-575)
        traj_steps = U(gen, (N,), *cfg.goal_ee.traj_time) / self.dt
        hold_steps = U(gen, (N,), *cfg.goal_ee.hold_time) / self.dt

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = EnvState(
            robot=engine.BodyState(q=z(N, m.nq), qd=z(N, m.nv)),
            box=engine.BodyState(q=z(N, 7), qd=z(N, 6)),
            episode_length=z(N, dtype=torch.int32),
            common_step=0,
            generator=gen,
            actions=z(N, cfg.env.num_actions),
            last_actions=z(N, cfg.env.num_actions),
            last_dof_vel=z(N, 20),
            action_history=z(N, cfg.env.action_delay + 2, cfg.env.num_actions),
            obs_history=z(N, cfg.env.history_len, self.num_proprio),
            torques=z(N, 20),
            commands=z(N, 3),
            traj_timesteps=traj_steps,
            traj_total_timesteps=traj_steps + hold_steps,
            goal_timer=z(N),
            ee_start_sphere=z(N, 3),
            ee_goal_sphere=z(N, 3),
            ee_goal_delta_orn_euler=z(N, 3),
            ee_goal_orn_euler=z(N, 3),
            curr_ee_goal_sphere=z(N, 3),
            curr_ee_goal_cart=z(N, 3),
            friction=friction,
            motor_strength=motor_strength,
            mass_params=mass_params,
            inert=inert,
            box_inert=box_inert,
            env_origins=origins,
            box_delta_y=box_delta_y,
            foot_forces=z(N, 4, 3),
            body_forces=z(N, m.nb, 3),
            contact_carry=fused.init_contact_carry(m, N, with_box=True,
                                                   device=dev),
            feet_air_time=z(N, 4),
            last_contacts=z(N, 4, dtype=torch.bool),
            episode_reward=z(N),
            episode_arm_reward=z(N),
            episode_sums={k: z(N) for k in
                          self.reward_names + self.arm_reward_names},
            metric_sums={k: z(N) for k in self.metric_names},
            reset_buf=z(N, dtype=torch.bool),
            time_out_buf=z(N, dtype=torch.bool),
        )
        # initial reset of all envs (reset() -> reset_idx(all) semantics)
        all_mask = torch.ones((N,), dtype=torch.bool, device=dev)
        return self._reset_envs(gen, state, all_mask, all_mask,
                                self.curriculum(0.0))

    def _reset_envs(self, gen, state: EnvState, mask, command_mask,
                    curr) -> EnvState:
        """Masked reset of robot+box states, commands, EE goals, buffers
        (widowGo1.py:695-754, _reset_dofs :816-828, _reset_root_states
        :757-802)."""
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        U = self._uniform

        # dofs: default * U(0.8, 1.2), clamped into limits
        scale = U(gen, (N, m.nj), 0.8, 1.2)
        dof_pos = torch.clamp(self.default_dof_pos[None] * scale,
                              self.dof_lower, self.dof_upper)

        # root: origin + xy perturb + ABSOLUTE init height, like the
        # reference (widowGo1.py:212, :766); vel perturb
        opr = cfg.terrain.origin_perturb_range
        base_xy = state.env_origins[:, :2] + U(gen, (N, 2), -opr, opr)
        base_xy = torch.stack([torch.clamp(base_xy[:, 0], max=self._wall_x),
                               base_xy[:, 1]], -1)
        ground = self.hf.sample(base_xy[:, 0], base_xy[:, 1])
        if self.spawn_relative:
            # opt-in divergence: terrain-relative spawn at ground + 0.40 ~=
            # stance height + 1.5 cm. The absolute spawn gives the deepest
            # drop exactly on the low cells with the least z-margin, and
            # the landing transient terminates many fresh spawns.
            base_z = ground + 0.40
        else:
            base_z = torch.full_like(ground, cfg.init_state.pos[2])
        quat = torch.zeros((N, 4), device=dev)
        quat[:, 3] = 1.0
        q = torch.cat([base_xy, base_z[:, None], quat, dof_pos], -1)
        ivp = cfg.terrain.init_vel_perturb_range
        qd = torch.cat([U(gen, (N, 6), -ivp, ivp),
                        torch.zeros((N, m.nj), device=dev)], -1)
        m1 = mask[:, None]
        robot_q = torch.where(m1, q, state.robot.q)
        robot_qd = torch.where(m1, qd, state.robot.qd)

        # box beside the robot (x-offset relative; see the JAX env's notes)
        box_q = torch.cat([
            (base_xy[:, 0] + cfg.box.box_env_origins_x)[:, None],
            (base_xy[:, 1] + state.box_delta_y)[:, None],
            (ground + cfg.box.box_env_origins_z)[:, None], quat], -1)
        box_q = torch.where(m1, box_q, state.box.q)
        box_qd = torch.where(m1, 0.0, state.box.qd)

        # commands: only command_mask envs resample (timeout-only on
        # in-episode resets, widowGo1.py:723-727)
        new_cmd = self._sample_commands(gen, N, curr)
        commands = torch.where(command_mask[:, None], new_cmd, state.commands)

        m3 = mask[:, None, None]
        state = _replace(
            state,
            robot=engine.BodyState(q=robot_q, qd=robot_qd),
            box=engine.BodyState(q=box_q, qd=box_qd),
            commands=commands,
            episode_length=torch.where(mask, 0, state.episode_length),
            last_actions=torch.where(m1, 0.0, state.last_actions),
            last_dof_vel=torch.where(m1, 0.0, state.last_dof_vel),
            contact_carry={k: torch.where(m3, 0.0, v)
                           for k, v in state.contact_carry.items()},
            feet_air_time=torch.where(m1, 0.0, state.feet_air_time),
            episode_reward=torch.where(mask, 0.0, state.episode_reward),
            episode_arm_reward=torch.where(mask, 0.0,
                                           state.episode_arm_reward),
            action_history=torch.where(m3, 0.0, state.action_history),
            obs_history=torch.where(m3, 0.0, state.obs_history),
            goal_timer=torch.where(mask, 0.0, state.goal_timer),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()},
            metric_sums={k: torch.where(mask, 0.0, v)
                         for k, v in state.metric_sums.items()},
        )
        # EE goal re-init for reset envs, using their (new) base yaw
        _, _, base_yaw = maths.euler_from_quat(robot_q[:, 3:7])
        zeros = torch.zeros_like(base_yaw)
        base_yaw_euler = torch.stack([zeros, zeros, base_yaw], -1)
        return self._resample_ee_goal(gen, state, mask, curr, base_yaw_euler)

    # ------------------------------------------------------------------
    # torque model (widowGo1.py:1262-1295)

    def _pd_torques(self, actions, dof_pos, dof_vel, motor_strength):
        """PD torques on the 18 actuated dofs + zero gripper torques. With
        adaptive_arm_gains the trailing 6 action dims are per-env arm kp
        deltas, kd = 2*sqrt(kp) (widowGo1.py:1283-1288)."""
        scaled = actions[:, :18] * motor_strength * self.action_scale
        target = scaled + self.default_dof_pos[None, :18] + self.droop_comp
        if self.cfg.control.adaptive_arm_gains:
            # floored at 0 here; the update's forward model floors at 1e-6
            # for its gradient (rl/ppo.py)
            arm_p = torch.clamp(self.p_gains[12:] + actions[:, 18:24], min=0.0)
            n = actions.shape[0]
            p_g = torch.cat([self.p_gains[:12].expand(n, 12), arm_p], -1)
            d_g = torch.cat([self.d_gains[:12].expand(n, 12),
                             2.0 * torch.sqrt(arm_p)], -1)
        else:
            p_g, d_g = self.p_gains, self.d_gains
        tau = p_g * (target - dof_pos) - d_g * dof_vel
        tau20 = torch.cat([tau, torch.zeros_like(tau[:, :2])], -1)
        return torch.clamp(tau20, -self.torque_limits, self.torque_limits)

    def _compute_torques(self, state: EnvState, actions):
        return self._pd_torques(actions, state.robot.q[:, 7:7 + 18],
                                state.robot.qd[:, 6:6 + 18],
                                state.motor_strength)

    # ------------------------------------------------------------------
    # the step

    def step(self, state: EnvState, actions: torch.Tensor, counter: float):
        cfg = self.cfg
        curr = self.curriculum(counter)

        # 1. clip + action delay buffer (widowGo1.py:1162-1173)
        actions = torch.clamp(actions, -cfg.normalization.clip_actions,
                              cfg.normalization.clip_actions)
        action_history = torch.cat([state.action_history[:, 1:],
                                    actions[:, None, :]], 1)
        delayed = action_history[:, -cfg.env.action_delay - 1]
        state = _replace(state, actions=delayed, action_history=action_history)

        # torque-supervision extras at substep 0, pre-physics
        # (widowGo1.py:1178-1182)
        extras = {}
        if cfg.control.torque_supervision:
            with spans.span("env.osc"):
                extras["target_arm_torques"] = self._osc_target(state)
            extras["current_arm_dof_pos"] = state.robot.q[:, 7 + 12:7 + 18]
            extras["current_arm_dof_vel"] = state.robot.qd[:, 6 + 12:6 + 18]

        # 2. decimation x physics (widowGo1.py:1175-1191)
        motor_strength = state.motor_strength

        def tau_fn(q, qd):
            return self._pd_torques(delayed, q[:, 7:7 + 18], qd[:, 6:6 + 18],
                                    motor_strength)

        with spans.span("env.physics"):
            out, box_q_n, box_qd_n = self.fused_step(
                state.robot.q, state.robot.qd, tau_fn,
                state.inert.mass, state.inert.com, state.inert.inertia,
                torch.clamp(state.friction, min=0.0), cfg.control.decimation,
                box_q=state.box.q, box_qd=state.box.qd,
                box_mass=state.box_inert.mass[:, 0],
                box_i_diag=torch.diagonal(state.box_inert.inertia[:, 0],
                                          dim1=-2, dim2=-1),
                contact_carry=state.contact_carry)
        with spans.span("env.post"):
            return self._post_physics(state, out, box_q_n, box_qd_n, curr,
                                      extras)

    def _post_physics(self, state: EnvState, out, box_q_n, box_qd_n, curr,
                      extras):
        """The step after its physics: bookkeeping, goal and commands,
        pushes, termination, rewards, stats, masked reset, observations."""
        cfg = self.cfg
        N = self.num_envs
        gen = state.generator
        box = engine.BodyState(q=box_q_n, qd=box_qd_n)
        robot = engine.BodyState(q=out.q, qd=out.qd)

        # 3. post-physics bookkeeping
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1
        state = _replace(state, robot=robot, box=box, torques=out.torques,
                         contact_carry=out.contact_carry,
                         foot_forces=out.foot_forces,
                         body_forces=out.body_forces,
                         episode_length=episode_length,
                         common_step=common_step)

        base_quat = robot.q[:, 3:7]
        roll, pitch, base_yaw = maths.euler_from_quat(base_quat)
        zeros = torch.zeros_like(base_yaw)
        base_yaw_quat = maths.quat_from_euler_xyz(zeros, zeros, base_yaw)
        base_yaw_euler = torch.stack([zeros, zeros, base_yaw], -1)
        base_lin_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 0:3])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 3:6])

        # 4. EE goal advance + expiry resample (widowGo1.py:1344-1350)
        t = torch.clamp(state.goal_timer / state.traj_timesteps,
                        0.0, 1.0)[:, None]
        curr_sphere = state.ee_start_sphere * (1 - t) + state.ee_goal_sphere * t
        curr_cart = maths.sphere2cart(curr_sphere)
        goal_timer = state.goal_timer + 1
        state = _replace(state, curr_ee_goal_sphere=curr_sphere,
                         curr_ee_goal_cart=curr_cart, goal_timer=goal_timer)
        expired = goal_timer > state.traj_total_timesteps
        state = self._resample_ee_goal(gen, state, expired, curr,
                                       base_yaw_euler)

        # 5. command resample for period-elapsed envs (widowGo1.py:917-925)
        resample_mask = (episode_length % self.resample_interval) == 0
        new_cmd = self._sample_commands(gen, N, curr)
        state = _replace(state, commands=torch.where(
            resample_mask[:, None], new_cmd, state.commands))

        # 6. pushes (widowGo1.py:804-814): 2.5x when the command is zero
        if (cfg.domain_rand.push_robots
                and common_step % self.push_interval == 0):
            mp = cfg.domain_rand.max_push_vel_xy
            push_vel = self._uniform(gen, (N, 2), -mp, mp)
            push_vel = torch.where(
                torch.sum(state.commands, dim=1, keepdim=True) == 0,
                push_vel * 2.5, push_vel)
            robot = engine.BodyState(
                q=robot.q, qd=torch.cat([push_vel, robot.qd[:, 2:]], -1))
            state = _replace(state, robot=robot)

        # 7. EE world pose + foot sensor frames
        ee_pos, ee_orn, foot_rot = self._ee_world(robot.q)
        # force-sensor reading: world contact force in the foot link frame
        foot_forces_sensor = torch.einsum("nfji,nfj->nfi", foot_rot,
                                          state.foot_forces)

        # 8. termination (widowGo1.py:937-963)
        curr_goal = (curr_sphere if cfg.goal_ee.command_mode == "sphere"
                     else curr_cart)
        r_term, p_term, z_term, contact_term = self.check_termination(
            state, roll, pitch, curr_goal)
        time_out = episode_length > self.max_episode_length
        # blow-up guard: non-finite state or a ballistic base must
        # terminate explicitly, NaN-poisoned comparisons never fire
        bad = (~torch.all(torch.isfinite(robot.q), -1)
               | ~torch.all(torch.isfinite(robot.qd), -1)
               | (torch.amax(torch.abs(robot.qd[:, :3]), -1) > 15.0)
               | ~torch.all(torch.isfinite(box.q), -1)
               | ~torch.all(torch.isfinite(box.qd), -1))
        reset_buf = contact_term | r_term | p_term | z_term | time_out | bad

        # 9. rewards (dual; NOT dt-scaled; /100 — widowGo1.py:170-205)
        rew, arm_rew, ep_sums, met_sums, new_air, new_contacts = self._rewards(
            state, base_lin_vel, base_ang_vel, base_yaw_quat, ee_pos, ee_orn,
            curr, reset_buf, time_out, foot_forces_sensor)
        state = _replace(state, feet_air_time=new_air,
                         last_contacts=new_contacts)
        # exploded envs produce garbage rewards on their final step
        rew = torch.where(torch.isfinite(rew) & ~bad, rew, 0.0)
        arm_rew = torch.where(torch.isfinite(arm_rew) & ~bad, arm_rew, 0.0)
        ep_sums = {k: torch.where(torch.isfinite(v), v, 0.0)
                   for k, v in ep_sums.items()}
        met_sums = {k: torch.where(torch.isfinite(v), v, 0.0)
                    for k, v in met_sums.items()}
        state = _replace(state, episode_sums=ep_sums, metric_sums=met_sums)

        # 10. episode stats BEFORE reset clears sums
        ep_s = self.cfg.env.episode_length_s
        stats = {}
        for k, v in ep_sums.items():
            stats["rew_" + k] = torch.sum(torch.where(reset_buf, v, 0.0)) / ep_s
        for k, v in met_sums.items():
            stats["metric_" + k] = torch.sum(torch.where(reset_buf, v, 0.0)) / ep_s
        ep_rew = state.episode_reward + rew
        ep_arm = state.episode_arm_reward + arm_rew
        stats["reward_sum"] = torch.sum(torch.where(reset_buf, ep_rew, 0.0))
        stats["arm_reward_sum"] = torch.sum(torch.where(reset_buf, ep_arm, 0.0))
        stats["len_sum"] = torch.sum(torch.where(
            reset_buf, episode_length.to(torch.float32), 0.0))
        stats["term_roll"] = torch.sum(r_term)
        stats["term_pitch"] = torch.sum(p_term)
        stats["term_z"] = torch.sum(z_term)
        stats["term_timeout"] = torch.sum(time_out)
        stats["term_bad"] = torch.sum(bad)
        ground_b = self.hf.sample(robot.q[:, 0], robot.q[:, 1])
        stats["step_base_height_rel"] = torch.mean(robot.q[:, 2] - ground_b)
        stats["step_z_margin_low"] = torch.mean(
            (robot.q[:, 2] - cfg.termination.z_threshold < 0.03)
            .to(torch.float32))
        stats["step_vel_x"] = torch.mean(base_lin_vel[:, 0])
        stats["step_cmd_x"] = torch.mean(state.commands[:, 0])
        state = _replace(state, episode_reward=ep_rew,
                         episode_arm_reward=ep_arm)

        # 11. masked reset (command resample only for timed-out envs)
        state = self._reset_envs(gen, state, reset_buf, reset_buf & time_out,
                                 curr)
        state = _replace(state, reset_buf=reset_buf, time_out_buf=time_out)

        # 12. observations from the (possibly reset) state
        obs, obs_history = self._observations(state)
        state = _replace(state, obs_history=obs_history,
                         last_actions=state.actions,
                         last_dof_vel=state.robot.qd[:, 6:])
        return state, StepOut(
            obs=obs, rew=rew, arm_rew=arm_rew, reset=reset_buf,
            time_outs=time_out, episode_stats=stats,
            num_resets=torch.sum(reset_buf), extras=extras)

    def reset(self, gen: torch.Generator):
        """Full env-batch build + initial observation, drawing from `gen`
        (a torch.Generator on the env's device), which the state keeps."""
        state = self.init_state(gen)
        obs, obs_history = self._observations(state)
        return _replace(state, obs_history=obs_history), obs

    # ------------------------------------------------------------------

    def _ee_world(self, q):
        """EE gripper world position + xyzw orientation, plus the foot-link
        world rotations (N, 4, 3, 3) for the force-sensor frames."""
        R, p, *_ = self.fused_step.fk(q)
        rot = R[self.gripper_body]
        pos = p[self.gripper_body] + rot @ self.ee_offset
        foot_rot = torch.stack([R[b] for b in self.feet_bodies], 1)
        return pos, maths.mat_to_quat(rot), foot_rot

    def _observations(self, state: EnvState):
        """proprio(76) + priv(24) + history(760) (widowGo1.py:966-1001)."""
        cfg = self.cfg
        sc = cfg.normalization.obs_scales
        robot = state.robot
        base_quat = robot.q[:, 3:7]
        roll, pitch, _ = maths.euler_from_quat(base_quat)
        base_ang_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 3:6])
        dof_pos = robot.q[:, 7:].clone()
        # wrap the waist (continuous joint) like dof_pos_wrapped[:, -8]
        dof_pos[:, 12] = maths.wrap_to_pi(dof_pos[:, 12])
        dof_vel = robot.qd[:, 6:]
        foot_contacts = torch.linalg.norm(state.foot_forces, dim=-1) > 1.5
        curr_goal = (state.curr_ee_goal_sphere
                     if cfg.goal_ee.command_mode == "sphere"
                     else state.curr_ee_goal_cart)
        device_lib.host_sync(self.device)
        commands_scale = torch.tensor([sc.lin_vel, sc.lin_vel, sc.ang_vel],
                                      device=self.device)
        prop = torch.cat([
            torch.stack([roll, pitch], -1),
            base_ang_vel * sc.ang_vel,
            (dof_pos - self.default_dof_pos[None]) * sc.dof_pos,
            dof_vel * sc.dof_vel,
            state.action_history[:, -1],
            foot_contacts.to(torch.float32),
            state.commands * commands_scale,
            curr_goal,
            state.ee_goal_delta_orn_euler,
        ], -1)
        priv = torch.cat([state.mass_params, state.friction[:, None],
                          state.motor_strength - 1.0], -1)
        obs = torch.cat([prop, priv,
                         state.obs_history.reshape(self.num_envs, -1)], -1)
        clip = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip, clip)

        # history roll with first-step broadcast (widowGo1.py:994-1001)
        first = (state.episode_length <= 1)[:, None, None]
        rolled = torch.cat([state.obs_history[:, 1:], prop[:, None, :]], 1)
        broadcast = prop[:, None, :].expand(-1, cfg.env.history_len, -1)
        return obs, torch.where(first, broadcast, rolled)

    def enable_droop_compensation(self):
        """Set the LEG PD-target gravity compensation: explicit PD at kp=50
        droops tau_g/kp under gravity, sagging the stance below the
        default-pose height; adding tau_g(q_default)/kp to the PD target
        moves the standing equilibrium to the pose the config describes.
        Standing legs feel gravity through the CONTACT reaction, not the
        free-base bias: tau_leg = J_foot^T f with each foot carrying ~W/4.
        The arm dofs are left uncompensated. Build-time work on the CPU;
        the 18 numbers then move to the env's device."""
        m = self.model
        q_ref = self._q_ref.to("cpu")
        weight = float(np.sum(np.asarray(m.mass, np.float32))) * 9.81
        f_foot = torch.tensor([0.0, 0.0, weight / 4.0])
        p_gains = self.p_gains.cpu()
        droop = [0.0] * 18
        geom_body = np.asarray(m.geom_body)
        geom_off = np.asarray(m.geom_pos, np.float32)
        kin = dynamics.fk(m, q_ref, torch.zeros(m.nv))
        for g in self.feet_geoms:
            b = int(geom_body[g])
            J = dynamics.body_jacobian(m, q_ref, b,
                                       torch.as_tensor(geom_off[g]), kin=kin)
            # the 3 joints of this leg: ancestors of the calf body
            i, cols = b, []
            while i > 0 and len(cols) < 3:
                cols.append(6 + i - 1)
                i = int(m.parent[i])
            for c in cols:
                j = c - 6
                if j < 12:  # leg dofs only
                    droop[j] = float(J[0:3, c] @ f_foot) / float(p_gains[j])
        self.droop_comp = torch.tensor(droop, dtype=torch.float32,
                                       device=self.device)

    def _osc_target(self, state: EnvState):
        """Operational-space control expert torques for supervision
        (widowGo1.py:1217-1242): u = J^T Lambda (kp dpose - kd v_ee) + g(q),
        (N, 6), batched over the envs. Each call counts once under
        `osc_target`."""
        spans.count("osc_target")
        m = self.model
        q, qd = state.robot.q, state.robot.qd
        arm = slice(6 + 12, 6 + 18)
        M = dynamics.crba(m, state.inert, q)
        mm = M[:, arm, arm]
        kin = dynamics.fk(m, q, qd)
        j_eef = dynamics.body_jacobian(m, q, self.gripper_body,
                                       self.ee_offset, kin=kin)[:, :, arm]
        rot = kin.rot[:, self.gripper_body]
        r_off = (rot @ self.ee_offset)
        ee_pos = kin.pos[:, self.gripper_body] + r_off
        ee_orn = maths.mat_to_quat(rot)
        # ee spatial velocity [lin; ang]
        vel = kin.vel[:, self.gripper_body]
        w_w = (rot @ vel[:, :3, None])[..., 0]
        v_w = (rot @ vel[:, 3:, None])[..., 0] + torch.linalg.cross(w_w, r_off)
        ee_vel6 = torch.cat([v_w, w_w], -1)

        # Damped solves instead of a pseudo-inverse: an SVD-based pinv on
        # an ill-conditioned arm block (collapsed or singular
        # configurations) gives NaNs that poison the supervision loss. mm
        # is SPD, and Lambda = (J M^-1 J^T + lambda I)^-1 is the standard
        # damped-least-squares OSC; the damping only matters near
        # singularities.
        eye6 = torch.eye(6, device=self.device)
        m_inv_jt = maths.solve_spd(mm + 1e-6 * eye6, j_eef.transpose(-1, -2))
        a = j_eef @ m_inv_jt + 1e-4 * eye6
        yq = maths.yaw_quat(q[:, 3:7])
        target = torch.cat([q[:, 0:2], torch.full_like(
            q[:, :1], self.z_invariant_offset)], -1) + maths.quat_rotate(
            yq, state.curr_ee_goal_cart)
        pos_err = target - ee_pos
        device_lib.host_sync(self.device)
        ee_orn_des = torch.tensor([0.0, 0.7071068, 0.0, 0.7071068],
                                  device=self.device)
        orn_err = maths.orientation_error(ee_orn_des, maths.normalize(ee_orn))
        dpose = torch.cat([pos_err, orn_err], -1)
        wrench = maths.solve_spd(a, self.osc_kp * dpose - self.osc_kd * ee_vel6)
        u = (j_eef.transpose(-1, -2) @ wrench[..., None])[..., 0]
        # gravity compensation from the RNEA bias at zero velocity
        bias = dynamics.rnea_bias(m, state.inert, q, torch.zeros_like(qd))
        return u + bias[:, arm]

    def check_termination(self, state: EnvState, roll, pitch, curr_goal):
        """Goal-conditioned roll/pitch + absolute-z + contact-force
        termination causes (widowGo1.py:937-963)."""
        robot = state.robot
        r_term = (((roll > 0.2) & (curr_goal[:, 2] >= 0))
                  | ((roll < -0.2) & (curr_goal[:, 2] <= 0)))
        p_term = (((pitch > 0.2) & (curr_goal[:, 1] >= 0))
                  | ((pitch < -0.2) & (curr_goal[:, 1] <= 0)))
        # ABSOLUTE root z, exactly as the reference (widowGo1.py:948)
        z_term = robot.q[:, 2] < self.cfg.termination.z_threshold
        if self.termination_bodies.numel():
            term_f = torch.linalg.norm(
                state.body_forces[:, self.termination_bodies], dim=-1)
            contact_term = torch.any(term_f > 1.0, dim=-1)
        else:
            contact_term = torch.zeros_like(z_term)
        return r_term, p_term, z_term, contact_term

    def _rewards(self, state: EnvState, base_lin_vel, base_ang_vel,
                 base_yaw_quat, ee_pos, ee_orn, curr, reset_buf, time_out,
                 foot_forces_sensor):
        """The full selectable reward library (widowGo1.py:1352-1469 + the
        base legged_robot.py:832-922 terms), scales applied, episode and
        metric sums updated. Each head divided by 100."""
        cfg = self.cfg
        s = cfg.rewards.scales
        a = cfg.rewards.arm_scales
        N = self.num_envs
        dev = self.device
        robot = state.robot
        torques = state.torques
        dof_pos = robot.q[:, 7:]
        dof_vel = robot.qd[:, 6:]
        cmd = state.commands
        ep = dict(state.episode_sums)
        met = dict(state.metric_sums)
        base_quat = robot.q[:, 3:7]
        device_lib.host_sync(dev)
        projected_gravity = maths.quat_rotate_inverse(
            base_quat, torch.tensor([0.0, 0.0, -1.0], device=dev).expand(N, 3))

        # foot contact bookkeeping for feet_air_time (legged_robot.py:898-909)
        contact = state.foot_forces[:, :, 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        air_time = state.feet_air_time + self.dt

        lin_err = torch.abs(cmd[:, 0] - base_lin_vel[:, 0])
        met["tracking_lin_vel_x_l1"] = met["tracking_lin_vel_x_l1"] + lin_err
        yaw_err = torch.abs(cmd[:, 2] - base_ang_vel[:, 2])
        met["tracking_ang_vel_yaw_exp"] = met["tracking_ang_vel_yaw_exp"] + yaw_err
        leg_power = torques[:, :12] * dof_vel[:, :12]
        energy_sq = torch.sum(torch.square(leg_power), -1)
        met["energy_square"] = met["energy_square"] + energy_sq
        device_lib.host_sync(dev)   # the index list's copy
        hip_l2 = torch.sum(torch.square(state.actions[:, [0, 3, 6, 9]]), -1)
        met["leg_action_l2"] = met["leg_action_l2"] + hip_l2
        # sensor-frame z, like the reference's foot force sensors (:1456)
        foot_z = torch.sum(torch.square(foot_forces_sensor[:, :, 2]), -1)
        met["foot_contacts_z"] = met["foot_contacts_z"] + foot_z
        torque_sq = torch.sum(torch.square(torques), -1)
        met["torque"] = met["torque"] + torque_sq
        leg_energy_abs = torch.sum(torch.abs(leg_power), -1)
        met["leg_energy_abs_sum"] = met["leg_energy_abs_sum"] + leg_energy_abs

        rew_air = torch.sum((air_time - 0.5) * first_contact, -1)
        rew_air = rew_air * (torch.linalg.norm(cmd[:, :2], dim=1) > 0.1)
        if self.penalized_bodies.numel():
            pen_f = torch.linalg.norm(
                state.body_forces[:, self.penalized_bodies], dim=-1)
            collision = torch.sum((pen_f > 0.1).to(torch.float32), -1)
        else:
            collision = torch.zeros(N, device=dev)
        sigma = cfg.rewards.tracking_sigma

        terms = {
            "energy_square": lambda: energy_sq,
            "survive": lambda: torch.ones(N, device=dev),
            "tracking_lin_vel_x_l1": lambda: -lin_err + torch.abs(cmd[:, 0]),
            "tracking_ang_vel_yaw_exp": lambda: torch.exp(-yaw_err / sigma),
            "hip_action_l2": lambda: hip_l2,
            "foot_contacts_z": lambda: foot_z,
            "tracking_lin_vel_x_exp": lambda: torch.exp(-lin_err / sigma),
            "tracking_ang_vel_yaw_l1": lambda: -yaw_err + torch.abs(cmd[:, 2]),
            "tracking_lin_vel_y_l2": lambda: torch.square(
                cmd[:, 1] - base_lin_vel[:, 1]),
            # reference :1449-1450 indexes cmd[:,2] vs lin vel z (verbatim)
            "tracking_lin_vel_z_l2": lambda: torch.square(
                cmd[:, 2] - base_lin_vel[:, 2]),
            "leg_energy": lambda: torch.sum(leg_power, -1),
            "leg_energy_abs_sum": lambda: leg_energy_abs,
            "leg_energy_sum_abs": lambda: torch.abs(torch.sum(leg_power, -1)),
            "leg_action_l2": lambda: torch.sum(
                torch.square(state.actions[:, :12]), -1),
            "torques": lambda: torque_sq,
            "termination": lambda: (reset_buf & ~time_out).to(torch.float32),
            "tracking_lin_vel": lambda: torch.exp(-torch.sum(torch.square(
                cmd[:, :2] - base_lin_vel[:, :2]), -1) / sigma),
            "tracking_ang_vel": lambda: torch.exp(-torch.square(
                cmd[:, 2] - base_ang_vel[:, 2]) / sigma),
            "lin_vel_z": lambda: torch.square(base_lin_vel[:, 2]),
            "ang_vel_xy": lambda: torch.sum(
                torch.square(base_ang_vel[:, :2]), -1),
            "orientation": lambda: torch.sum(
                torch.square(projected_gravity[:, :2]), -1),
            "dof_vel": lambda: torch.sum(torch.square(dof_vel), -1),
            "dof_acc": lambda: torch.sum(torch.square(
                (state.last_dof_vel - dof_vel) / self.dt), -1),
            "base_height": lambda: torch.square(
                robot.q[:, 2] - cfg.rewards.base_height_target),
            "feet_air_time": lambda: rew_air,
            "collision": lambda: collision,
            "feet_stumble": lambda: torch.any(
                torch.linalg.norm(state.foot_forces[:, :, :2], dim=-1)
                > 5 * torch.abs(state.foot_forces[:, :, 2]),
                dim=-1).to(torch.float32),
            "action_rate": lambda: torch.sum(torch.square(
                state.last_actions - state.actions), -1),
            "stand_still": lambda: (torch.sum(
                torch.abs(dof_pos - self.default_dof_pos[None]), -1)
                * (torch.linalg.norm(cmd[:, :2], dim=1) < 0.1)),
        }
        # the curriculum overwrites the tracking_ang_vel_yaw_exp scale
        # (widowGo1.py:683)
        rew = torch.zeros(N, device=dev)
        for k in self.reward_names:
            scale = (float(curr["tracking_ang_vel_yaw_exp"])
                     if k == "tracking_ang_vel_yaw_exp" else getattr(s, k))
            r = scale * terms[k]()
            rew = rew + r
            ep[k] = ep[k] + r
        if cfg.rewards.only_positive_rewards:
            rew = torch.clamp(rew, min=0.0)
        rew = rew / 100.0

        # --- arm terms ---
        base_xy_z = torch.cat([robot.q[:, 0:2],
                               torch.full((N, 1), self.z_invariant_offset,
                                          device=dev)], -1)
        ee_local = maths.quat_rotate_inverse(base_yaw_quat, ee_pos - base_xy_z)
        sphere_err = torch.sum(
            torch.abs(maths.cart2sphere(ee_local) - state.curr_ee_goal_sphere)
            * self.sphere_error_scale, -1)
        met["tracking_ee_sphere"] = met["tracking_ee_sphere"] + sphere_err
        target_ee = base_xy_z + maths.quat_rotate(base_yaw_quat,
                                                  state.curr_ee_goal_cart)
        cart_err = torch.sum(torch.abs(ee_pos - target_ee), -1)
        met["tracking_ee_cart"] = met["tracking_ee_cart"] + cart_err
        ee_orn_euler = torch.stack(maths.euler_from_quat(ee_orn), -1)
        orn_delta = maths.wrap_to_pi(
            state.ee_goal_orn_euler - ee_orn_euler) * self.orn_error_scale
        orn_err = torch.sum(torch.abs(orn_delta), -1)
        device_lib.host_sync(dev)   # the index list's copy
        orn_err_ry = torch.sum(torch.abs(orn_delta[:, [0, 2]]), -1)
        met["tracking_ee_orn"] = met["tracking_ee_orn"] + orn_err_ry
        arm_energy = torch.sum(
            torch.abs(torques[:, 12:18] * dof_vel[:, 12:18]), -1)

        sig = cfg.rewards.tracking_ee_sigma
        arm_terms = {
            "tracking_ee_sphere": lambda: torch.exp(-sphere_err / sig),
            "tracking_ee_cart": lambda: torch.exp(-cart_err / sig),
            "tracking_ee_orn": lambda: torch.exp(-orn_err / sig),
            "tracking_ee_orn_ry": lambda: torch.exp(-orn_err_ry / sig),
            "arm_energy_abs_sum": lambda: arm_energy,
            "termination": lambda: (reset_buf & ~time_out).to(torch.float32),
        }
        # the curriculum drives whichever tracking term the command mode
        # uses (widowGo1.py:689-692)
        curr_name = ("tracking_ee_sphere"
                     if "tracking_ee_sphere" in self.arm_reward_names
                     else "tracking_ee_cart")
        arm_rew = torch.zeros(N, device=dev)
        for k in self.arm_reward_names:
            scale = (float(curr["tracking_ee"]) if k == curr_name
                     else getattr(a, k))
            r = scale * arm_terms[k]()
            arm_rew = arm_rew + r
            ep[k] = ep[k] + r
        arm_rew = arm_rew / 100.0

        new_air = air_time * ~contact_filt
        return rew, arm_rew, ep, met, new_air, contact
