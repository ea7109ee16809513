"""Generic rough-terrain velocity-tracking locomotion env (go1 / a1 /
anymal / cassie family) on torch tensors.

Counterpart of dwbc_tpu/envs/legged_robot.py, the re-design of the
reference LeggedRobot (legged_robot.py:51-922): decimation-4 PD loop (or
the LSTM actuator net), heading-mode commands, game-inspired terrain
curriculum (move_up/move_down, :421-441), friction-bucket + base-mass DR,
pushes, 187-point height measurements with yaw-rotated grid and 3-tap min
(:777-829), the full 17-term reward set (:832-922) with dt-scaled pruned
scales (:548-567), uniform obs noise (:455-482), and where-masked
auto-resets — as `step(state, actions)` over an explicit `LeggedState`.

Random draws come from the `torch.Generator` the state carries (the JAX
package threads a PRNG key instead, so the two packages draw different
numbers from one seed). Everything that changes from step to step stays
on the device: the step counter, the curriculum-widened command range and
the push / curriculum ticks are 0-dim tensors selected with torch.where,
so a step never waits for the host. Python branches are taken only on
what the config fixes.

An env stepped inside a process group (parallel/distributed.active()) is
this rank's share of the job's envs: the command curriculum then decides
on the counts and tracking sums of all ranks (one all-reduce, on the
device), so that every rank widens its command range at the same step,
as the JAX package's global arrays do; the per-family terrain levels it
logs are the job's means in the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core import maths, urdf
from ..models import actuator_net
from ..parallel import distributed
from ..sim import dynamics, engine, fused
from ..sim.contact import ContactParams
from ..terrain import terrain as terr
from ..utils import spans
from ..utils.device import resolve_device
from .legged_config import LeggedRobotCfg


@dataclasses.dataclass
class LeggedState:
    robot: engine.BodyState
    episode_length: torch.Tensor     # (N,) int32
    common_step: torch.Tensor        # () int64, policy steps since the build
    generator: torch.Generator       # the env's random stream
    actions: torch.Tensor
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    torques: torch.Tensor
    commands: torch.Tensor           # (N, 4): vx, vy, wyaw, heading
    command_lin_vel_x: torch.Tensor  # (2,) curriculum-widened vx range
    feet_air_time: torch.Tensor      # (N, num_feet)
    last_contacts: torch.Tensor      # (N, num_feet) bool
    friction: torch.Tensor
    added_mass: torch.Tensor         # (N,)
    inert: dynamics.Inertial
    env_origins: torch.Tensor
    terrain_levels: torch.Tensor     # (N,) int64
    terrain_types: torch.Tensor      # (N,) int64
    foot_forces: torch.Tensor        # (N, num_feet, 3)
    body_forces: torch.Tensor        # (N, nb, 3) net per-body contact force
    contact_carry: Dict[str, torch.Tensor]  # warm-start contact forces
    episode_reward: torch.Tensor     # (N,) cumulative reward this episode
    actuator_hidden: torch.Tensor    # (layers, 2, N*nj, H) LSTM state (or (0,))
    episode_sums: Dict[str, torch.Tensor]
    reset_buf: torch.Tensor
    time_out_buf: torch.Tensor


class LeggedStepOut(NamedTuple):
    obs: torch.Tensor
    rew: torch.Tensor
    reset: torch.Tensor
    time_outs: torch.Tensor
    episode_stats: Dict[str, torch.Tensor]
    num_resets: torch.Tensor


_replace = dataclasses.replace


def _resolve_by_name(names, mapping, default=0.0):
    """Substring-keyed resolution like reference legged_robot.py:536-539."""
    out = []
    for n in names:
        v = default
        for k, val in mapping:
            if k in n:
                v = val
        out.append(v)
    return np.asarray(out, np.float32)


class LeggedRobotEnv:
    def __init__(self, cfg: LeggedRobotCfg, num_envs: int = 64, seed: int = 1,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.num_envs = num_envs
        self.model = m = urdf.load_urdf(cfg.asset.file,
                                        dof_order=cfg.asset.dof_order,
                                        armature=cfg.asset.armature)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        # terrain
        self.grid = None
        if cfg.terrain.mesh_type == "grid":
            self.grid = terr.grid_terrain(terr.GridTerrainCfg(
                horizontal_scale=cfg.terrain.horizontal_scale,
                vertical_scale=cfg.terrain.vertical_scale,
                border_size=cfg.terrain.border_size,
                terrain_length=cfg.terrain.terrain_length,
                terrain_width=cfg.terrain.terrain_width,
                num_rows=cfg.terrain.num_rows, num_cols=cfg.terrain.num_cols,
                terrain_proportions=cfg.terrain.terrain_proportions,
                curriculum=cfg.terrain.curriculum, seed=seed), device=dev)
            self.hf = self.grid.hf
            if cfg.terrain.measure_heights:
                self.hf = self.hf.with_min3()
            self.terrain_origins = f32(self.grid.env_origins)
        else:
            self.hf = terr.flat_plane(
                cfg.env_spacing * (int(np.sqrt(num_envs)) + 2) + 10, 1.0,
                device=dev)

        default_np = _resolve_by_name(m.dof_names,
                                      cfg.init_state.default_joint_angles)
        self.default_dof_pos = f32(default_np)
        self.p_gains = f32(_resolve_by_name(m.dof_names,
                                            cfg.control.stiffness))
        self.d_gains = f32(_resolve_by_name(m.dof_names, cfg.control.damping))
        self.torque_limits = f32(m.dof_effort)
        self.dof_lower = f32(m.dof_lower)
        self.dof_upper = f32(m.dof_upper)
        self.dof_vel_limits = f32(m.dof_velocity)
        self.dof_pos_limits_soft = tuple(f32(a) for a in self._soft_limits())
        q_ref = torch.zeros(m.nq)
        q_ref[6] = 1.0
        q_ref[2] = cfg.init_state.pos[2]
        q_ref[7:] = torch.as_tensor(default_np)
        self.ctx = engine.build_ctx(m, q_ref)
        self.sim_params = engine.SimParams(
            dt=cfg.sim_dt, contact=ContactParams(dt=cfg.sim_dt))

        self.dt = cfg.dt
        self.max_episode_length = cfg.max_episode_length
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s
                                         / self.dt))

        # body groups; feet live as geoms (foot bodies are merged into
        # calves)
        self.feet_geoms = np.asarray(m.geoms_of(cfg.asset.foot_name))
        if self.feet_geoms.shape[0] < 2:
            raise ValueError(f"no foot geoms matching "
                             f"{cfg.asset.foot_name!r} in {cfg.asset.file}")
        self.num_feet = int(self.feet_geoms.shape[0])

        def bodies_matching(substrs):
            idx = [i for i, bn in enumerate(m.body_names)
                   if any(s in bn for s in substrs)]
            # include merged-in link names via sites
            idx += [site.body for name, site in m.sites.items()
                    if any(s in name for s in substrs)]
            return torch.as_tensor(np.unique(np.asarray(idx, np.int64)),
                                   device=dev)

        self.penalized_bodies = bodies_matching(cfg.asset.penalize_contacts_on)
        self.termination_bodies = bodies_matching(
            cfg.asset.terminate_after_contacts_on)

        self.fused_step = fused.make_fused_substep(
            m, self.sim_params, self.hf, self.ctx, self.feet_geoms,
            device=dev)

        # LSTM actuator network replacing PD (anymal_c rough,
        # anymal.py:52-78)
        self.actuator_params = None
        if cfg.control.use_actuator_network:
            self.actuator_params = actuator_net.load_params(device=dev)

        # measurement grid (base frame)
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y),
                             indexing="ij")
        self.height_points = f32(np.stack([gx.ravel(), gy.ravel()], -1))

        self.reward_names = [k for k, v in
                             vars(cfg.rewards.scales).items() if v != 0.0]
        # scales multiplied by policy dt (legged_robot.py:552-558)
        self.reward_scales = {k: getattr(cfg.rewards.scales, k) * self.dt
                              for k in self.reward_names}
        self.num_obs = cfg.num_observations
        self.num_actions = cfg.num_actions
        self.noise_vec = f32(self._noise_scale_vec())
        sc = cfg.normalization
        self.commands_scale = f32([sc.lin_vel, sc.lin_vel, sc.ang_vel])
        # built once: a tensor made from Python numbers inside the step
        # would be a blocking host-to-device copy
        self._down = f32([0.0, 0.0, -1.0]).expand(num_envs, 3)
        self._forward = f32([1.0, 0.0, 0.0]).expand(num_envs, 3)
        # logged via the runner's metric_ channel (reference logs
        # extras["episode"]["max_command_x"], legged_robot.py:185)
        self.metric_names = (["max_command_x"]
                             if cfg.commands.curriculum else [])
        # per-terrain-family curriculum-level breakdown: a mean level of
        # 6/10 can hide "slopes at 9, stairs at 3". The grid's column ->
        # subterrain-family map is static, so the per-family means are
        # cheap masked reductions.
        self._fam_names, self._fam_of_col = [], None
        if self.grid is not None and cfg.terrain.curriculum:
            props = list(np.cumsum(cfg.terrain.terrain_proportions))
            names = ["slope", "rough_slope", "stairs_down", "stairs_up",
                     "obstacles", "stones", "gap", "pit"]
            ncols = cfg.terrain.num_cols
            # exact column->choice map of the grid generator
            # (terrain.py grid_heights: choice = j/num_cols + 0.001)
            choice = np.arange(ncols) / ncols + 0.001
            fam = np.searchsorted(np.asarray(props), choice, side="right")
            fam = np.minimum(fam, len(names) - 1)
            self._fam_of_col = torch.as_tensor(fam.astype(np.int64),
                                               device=dev)
            present = sorted(set(fam.tolist()))
            self._fam_names = [(f, names[f]) for f in present]
            self.metric_names = list(self.metric_names) + [
                f"level_{names[f]}" for f in present]

    # ------------------------------------------------------------------

    def _soft_limits(self):
        m = self.model
        lo, hi = np.asarray(m.dof_lower), np.asarray(m.dof_upper)
        mid = (lo + hi) / 2
        r = hi - lo
        s = self.cfg.rewards.soft_dof_pos_limit
        return mid - 0.5 * r * s, mid + 0.5 * r * s

    def _noise_scale_vec(self):
        """(legged_robot.py:455-482)"""
        cfg = self.cfg
        n = cfg.noise
        sc = cfg.normalization
        na = cfg.num_actions
        v = np.zeros(self.num_obs, np.float32)
        lv = n.noise_level
        v[0:3] = n.lin_vel * lv * sc.lin_vel
        v[3:6] = n.ang_vel * lv * sc.ang_vel
        v[6:9] = n.gravity * lv
        v[9:12] = 0.0
        v[12:12 + na] = n.dof_pos * lv * sc.dof_pos
        v[12 + na:12 + 2 * na] = n.dof_vel * lv * sc.dof_vel
        v[12 + 2 * na:12 + 3 * na] = 0.0
        if cfg.terrain.measure_heights:
            v[12 + 3 * na:] = n.height_measurements * lv * sc.height_measurements
        return v

    def _uniform(self, gen, shape, lo, hi):
        return maths.uniform(gen, shape, lo, hi, self.device)

    # ------------------------------------------------------------------

    def init_state(self, gen: torch.Generator) -> LeggedState:
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        U = self._uniform

        # terrain origins (legged_robot.py:717-742)
        if self.grid is not None:
            max_lvl = (cfg.terrain.max_init_terrain_level
                       if cfg.terrain.curriculum else cfg.terrain.num_rows - 1)
            levels = torch.randint(0, max_lvl + 1, (N,), generator=gen,
                                   device=dev)
            types = torch.arange(N, device=dev) * cfg.terrain.num_cols // N
            origins = self.terrain_origins[levels, types]
        else:
            side = int(np.ceil(np.sqrt(N)))
            xx, yy = np.meshgrid(np.arange(side), np.arange(side),
                                 indexing="ij")
            origins = torch.as_tensor(np.stack(
                [cfg.env_spacing * xx.ravel()[:N],
                 cfg.env_spacing * yy.ravel()[:N],
                 np.zeros(N)], -1).astype(np.float32), device=dev)
            levels = torch.zeros((N,), dtype=torch.long, device=dev)
            types = torch.zeros((N,), dtype=torch.long, device=dev)

        # DR
        dr = cfg.domain_rand
        buckets = U(gen, (dr.friction_buckets,), *dr.friction_range)
        bucket_ids = torch.randint(0, dr.friction_buckets, (N,),
                                   generator=gen, device=dev)
        friction = (buckets[bucket_ids] if dr.randomize_friction
                    else torch.ones(N, device=dev))
        added_mass = (U(gen, (N,), *dr.added_mass_range)
                      if dr.randomize_base_mass
                      else torch.zeros(N, device=dev))

        base = dynamics.default_inertial(m, dev)
        mass = base.mass[None].repeat(N, 1)
        mass[:, 0] += added_mass
        inert = dynamics.Inertial(
            mass=mass, com=base.com[None].repeat(N, 1, 1),
            inertia=base.inertia[None].repeat(N, 1, 1, 1))

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = LeggedState(
            robot=engine.BodyState(q=z(N, m.nq), qd=z(N, m.nv)),
            episode_length=z(N, dtype=torch.int32),
            common_step=z(dtype=torch.long),
            generator=gen,
            actions=z(N, m.nj),
            last_actions=z(N, m.nj),
            last_dof_vel=z(N, m.nj),
            torques=z(N, m.nj),
            commands=z(N, 4),
            command_lin_vel_x=torch.tensor(cfg.commands.lin_vel_x,
                                           dtype=torch.float32, device=dev),
            feet_air_time=z(N, self.num_feet),
            last_contacts=z(N, self.num_feet, dtype=torch.bool),
            friction=friction,
            added_mass=added_mass,
            inert=inert,
            env_origins=origins,
            terrain_levels=levels,
            terrain_types=types,
            foot_forces=z(N, self.num_feet, 3),
            body_forces=z(N, m.nb, 3),
            contact_carry=fused.init_contact_carry(m, N, device=dev),
            episode_reward=z(N),
            actuator_hidden=(actuator_net.init_hidden(N * m.nj, dev)
                             if cfg.control.use_actuator_network else z(0)),
            episode_sums={k: z(N) for k in self.reward_names},
            reset_buf=z(N, dtype=torch.bool),
            time_out_buf=z(N, dtype=torch.bool),
        )
        return self._reset_envs(
            gen, state, torch.ones((N,), dtype=torch.bool, device=dev),
            init=True)

    def _sample_commands(self, gen, state) -> torch.Tensor:
        """(legged_robot.py:337-351); vx range is the curriculum-widened
        one carried in state when commands.curriculum is on."""
        c = self.cfg.commands
        N = self.num_envs
        U = self._uniform
        vx = U(gen, (N,), state.command_lin_vel_x[0],
               state.command_lin_vel_x[1])
        vy = U(gen, (N,), *c.lin_vel_y)
        last = U(gen, (N,), *(c.heading if c.heading_command
                              else c.ang_vel_yaw))
        # zero small commands
        keep = (torch.linalg.norm(torch.stack([vx, vy], -1), dim=1)
                > 0.2).to(vx.dtype)
        zero = torch.zeros_like(vx)
        cols = [vx * keep, vy * keep, zero, zero]
        cols[3 if c.heading_command else 2] = last
        return torch.stack(cols, -1)

    def _reset_envs(self, gen, state: LeggedState, mask, init=False):
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        U = self._uniform

        # command curriculum (reference legged_robot.py:443-451, the
        # documented behavior of the commented-out update_command_curriculum
        # called from reset_idx :161-162): once per episode-length of common
        # steps, if the mean tracking reward of the resetting envs exceeds
        # 80% of its ceiling, widen the vx range by 0.5 up to max_curriculum.
        if cfg.commands.curriculum and not init:
            sel = torch.stack([torch.sum(mask.to(torch.float32)), torch.sum(
                torch.where(mask, state.episode_sums["tracking_lin_vel"],
                            0.0))])
            distributed.all_reduce_sum([sel])   # the job's resetting envs
            n_sel, track_sum = sel
            mean_track = (track_sum / torch.clamp(n_sel, min=1.0)
                          / self.max_episode_length)
            tick = (state.common_step % int(self.max_episode_length)) == 0
            grow = (tick & (n_sel > 0)
                    & (mean_track > 0.8 * self.reward_scales["tracking_lin_vel"]))
            mc = cfg.commands.max_curriculum
            lo = torch.clamp(state.command_lin_vel_x[0] - 0.5, -mc, 0.0)
            hi = torch.clamp(state.command_lin_vel_x[1] + 0.5, 0.0, mc)
            state = _replace(state, command_lin_vel_x=torch.where(
                grow, torch.stack([lo, hi]), state.command_lin_vel_x))

        # terrain curriculum (legged_robot.py:421-441) — not on initial reset
        origins = state.env_origins
        levels = state.terrain_levels
        if self.grid is not None and cfg.terrain.curriculum and not init:
            dist = torch.linalg.norm(
                state.robot.q[:, :2] - state.env_origins[:, :2], dim=1)
            move_up = dist > self.grid.length / 2
            cmd_dist = (torch.linalg.norm(state.commands[:, :2], dim=1)
                        * cfg.episode_length_s * 0.5)
            move_down = (dist < cmd_dist) & ~move_up
            new_levels = levels + move_up.long() - move_down.long()
            rand_levels = torch.randint(0, cfg.terrain.num_rows, (N,),
                                        generator=gen, device=dev)
            new_levels = torch.where(new_levels >= cfg.terrain.num_rows,
                                     rand_levels,
                                     torch.clamp(new_levels, min=0))
            levels = torch.where(mask, new_levels, levels)
            origins = torch.where(
                mask[:, None],
                self.terrain_origins[levels, state.terrain_types], origins)

        # dofs: default * U(0.5, 1.5) (legged_robot.py:385)
        scale = U(gen, (N, m.nj), 0.5, 1.5)
        dof_pos = torch.clamp(self.default_dof_pos[None] * scale,
                              self.dof_lower, self.dof_upper)
        base_xy = origins[:, :2]
        if self.grid is not None:
            base_xy = base_xy + U(gen, (N, 2), -1.0, 1.0)
        base_z = origins[:, 2:3] + cfg.init_state.pos[2]
        quat = torch.zeros((N, 4), device=dev)
        quat[:, 3] = 1.0
        q = torch.cat([base_xy, base_z, quat, dof_pos], -1)
        qd = torch.cat([U(gen, (N, 6), -0.5, 0.5),
                        torch.zeros((N, m.nj), device=dev)], -1)

        new_cmd = self._sample_commands(gen, state)

        actuator_hidden = state.actuator_hidden
        if cfg.control.use_actuator_network:
            h = actuator_hidden.reshape(2, 2, N, m.nj, 8)
            h = torch.where(mask[None, None, :, None, None], 0.0, h)
            actuator_hidden = h.reshape(2, 2, N * m.nj, 8)

        m1 = mask[:, None]
        return _replace(
            state,
            actuator_hidden=actuator_hidden,
            robot=engine.BodyState(
                q=torch.where(m1, q, state.robot.q),
                qd=torch.where(m1, qd, state.robot.qd)),
            commands=torch.where(m1, new_cmd, state.commands),
            env_origins=origins,
            terrain_levels=levels,
            episode_length=torch.where(mask, 0, state.episode_length),
            last_actions=torch.where(m1, 0.0, state.last_actions),
            last_dof_vel=torch.where(m1, 0.0, state.last_dof_vel),
            contact_carry={k: torch.where(mask[:, None, None], 0.0, v)
                           for k, v in state.contact_carry.items()},
            feet_air_time=torch.where(m1, 0.0, state.feet_air_time),
            episode_reward=torch.where(mask, 0.0, state.episode_reward),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()},
        )

    def _pd_torques(self, actions, q, qd, last_dof_vel):
        """(legged_robot.py:353-375)"""
        cfg = self.cfg
        scaled = actions * cfg.control.action_scale
        dof_pos = q[:, 7:]
        dof_vel = qd[:, 6:]
        ct = cfg.control.control_type
        if ct == "P":
            tau = (self.p_gains * (scaled + self.default_dof_pos - dof_pos)
                   - self.d_gains * dof_vel)
        elif ct == "V":
            tau = (self.p_gains * (scaled - dof_vel)
                   - self.d_gains * (dof_vel - last_dof_vel) / cfg.sim_dt)
        else:  # T
            tau = scaled
        return torch.clamp(tau, -self.torque_limits, self.torque_limits)

    def _measured_heights(self, q):
        """Yaw-rotated grid, 3-tap min (legged_robot.py:793-829)."""
        N, P = q.shape[0], self.height_points.shape[0]
        pts = torch.cat([self.height_points[None].expand(N, P, 2),
                         torch.zeros((N, P, 1), device=q.device)], -1)
        world = (maths.quat_apply_yaw(q[:, None, 3:7].expand(N, P, 4), pts)
                 + q[:, None, 0:3])
        return self.hf.sample_min3(world[..., 0], world[..., 1])

    # ------------------------------------------------------------------

    def step(self, state: LeggedState, actions: torch.Tensor
             ) -> Tuple[LeggedState, LeggedStepOut]:
        cfg = self.cfg
        N = self.num_envs
        m = self.model

        actions = torch.clamp(actions, -cfg.normalization.clip_actions,
                              cfg.normalization.clip_actions)
        state = _replace(state, actions=actions)
        fric = torch.clamp(state.friction, min=0.0)
        last_dof_vel = state.last_dof_vel
        args = (state.inert.mass, state.inert.com, state.inert.inertia, fric,
                cfg.control.decimation)

        if cfg.control.use_actuator_network:
            def tau_fn(hidden, q_arr, qd_arr):
                scaled = actions * cfg.control.action_scale
                pos_err = scaled + self.default_dof_pos - q_arr[:, 7:]
                x = torch.stack([pos_err.reshape(-1),
                                 qd_arr[:, 6:].reshape(-1)], -1)
                tau_flat, hidden = actuator_net.step(self.actuator_params, x,
                                                     hidden)
                tau = tau_flat.reshape(N, m.nj)
                return hidden, torch.clamp(tau, -self.torque_limits,
                                           self.torque_limits)

            with spans.span("env.physics"):
                out, hidden = self.fused_step(
                    state.robot.q, state.robot.qd, tau_fn, *args,
                    tau_carry=state.actuator_hidden,
                    contact_carry=state.contact_carry)
            state = _replace(state, actuator_hidden=hidden)
        else:
            def tau_fn(q_arr, qd_arr):
                return self._pd_torques(actions, q_arr, qd_arr, last_dof_vel)

            with spans.span("env.physics"):
                out = self.fused_step(state.robot.q, state.robot.qd, tau_fn,
                                      *args, contact_carry=state.contact_carry)
        with spans.span("env.post"):
            return self._post_physics(state, out)

    def _post_physics(self, state: LeggedState, out
                      ) -> Tuple[LeggedState, LeggedStepOut]:
        """The step after its physics: bookkeeping, commands, pushes,
        heights, termination, rewards, stats, masked reset, observations."""
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        gen = state.generator
        robot = engine.BodyState(q=out.q, qd=out.qd)
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1
        state = _replace(state, robot=robot, torques=out.torques,
                         foot_forces=out.foot_forces,
                         body_forces=out.body_forces,
                         contact_carry=out.contact_carry,
                         episode_length=episode_length,
                         common_step=common_step)

        base_quat = robot.q[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 0:3])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 3:6])
        projected_gravity = maths.quat_rotate_inverse(base_quat, self._down)

        # command resample + heading command (legged_robot.py:320-335)
        resample_mask = (episode_length % self.resample_interval) == 0
        new_cmd = self._sample_commands(gen, state)
        commands = torch.where(resample_mask[:, None], new_cmd, state.commands)
        if cfg.commands.heading_command:
            fwd = maths.quat_rotate(base_quat, self._forward)
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            yaw_cmd = torch.clamp(
                0.5 * maths.wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
            commands = torch.cat([commands[:, :2], yaw_cmd[:, None],
                                  commands[:, 3:]], -1)
        state = _replace(state, commands=commands)

        # pushes: drawn every step, applied on the interval's tick
        if cfg.domain_rand.push_robots:
            push_now = (common_step % self.push_interval) == 0
            mp = cfg.domain_rand.max_push_vel_xy
            push_vel = self._uniform(gen, (N, 2), -mp, mp)
            qd_pushed = torch.cat([push_vel, robot.qd[:, 2:]], -1)
            robot = engine.BodyState(
                q=robot.q, qd=torch.where(push_now, qd_pushed, robot.qd))
            state = _replace(state, robot=robot)

        # measured heights
        if cfg.terrain.measure_heights:
            measured = self._measured_heights(robot.q)
        else:
            measured = torch.zeros((N, 1), device=dev)

        # termination (legged_robot.py:138-143)
        if len(self.termination_bodies):
            term_force = torch.linalg.norm(
                state.body_forces[:, self.termination_bodies], dim=-1)
            contact_term = torch.any(term_force > 1.0, dim=-1)
        else:
            contact_term = torch.zeros((N,), dtype=torch.bool, device=dev)
        time_out = episode_length > self.max_episode_length
        # blow-up guard: NaN states never satisfy the termination
        # comparisons, so they must be caught explicitly
        bad = (~torch.all(torch.isfinite(robot.q), -1)
               | ~torch.all(torch.isfinite(robot.qd), -1)
               | (torch.amax(torch.abs(robot.qd[:, :3]), -1) > 15.0))
        reset_buf = contact_term | time_out | bad

        # rewards
        rew, ep_sums, new_air, new_contacts = self._rewards(
            state, base_lin_vel, base_ang_vel, projected_gravity, measured,
            reset_buf, time_out)
        rew = torch.where(torch.isfinite(rew) & ~bad, rew, 0.0)
        ep_sums = {k: torch.where(torch.isfinite(v), v, 0.0)
                   for k, v in ep_sums.items()}
        state = _replace(state, episode_sums=ep_sums, feet_air_time=new_air,
                         last_contacts=new_contacts)

        nres = torch.sum(reset_buf)
        nres_f = nres.to(torch.float32)
        stats = {"rew_" + k: torch.sum(torch.where(reset_buf, v, 0.0))
                 / cfg.episode_length_s
                 for k, v in ep_sums.items()}
        # TRUE episode reward/length sums harvested at termination (the
        # reference's rewbuffer/lenbuffer deques, on_policy_runner.py:140-154)
        ep_rew = state.episode_reward + rew
        stats["reward_sum"] = torch.sum(torch.where(reset_buf, ep_rew, 0.0))
        stats["len_sum"] = torch.sum(torch.where(
            reset_buf, episode_length.to(torch.float32), 0.0))
        state = _replace(state, episode_reward=ep_rew)
        lv = state.terrain_levels.to(torch.float32)
        stats["terrain_level"] = torch.mean(lv)
        if self._fam_of_col is not None:
            # per-family mean level, through the metric_ channel: the
            # runner divides metric_ sums by total resets, so scale by
            # this step's resets to make the division recover a
            # reset-weighted mean (same convention as max_command_x). The
            # mean is the job's: each family's level sum and env count
            # are summed over the ranks before the division, so the
            # ranks' scaled means add up to what one process would log.
            env_fam = self._fam_of_col[state.terrain_types]
            in_fam = torch.stack([env_fam == f for f, _ in self._fam_names])
            fam = torch.cat([torch.sum(torch.where(in_fam, lv, 0.0), -1),
                             torch.sum(in_fam, -1).to(torch.float32)])
            distributed.all_reduce_sum([fam])
            nf = len(self._fam_names)
            mean_lv = fam[:nf] / torch.clamp(fam[nf:], min=1.0)
            for i, (_, name) in enumerate(self._fam_names):
                stats[f"metric_level_{name}"] = mean_lv[i] * nres_f
        if cfg.commands.curriculum:
            # runner divides by total resets -> reports the current max
            stats["metric_max_command_x"] = state.command_lin_vel_x[1] * nres_f

        state = self._reset_envs(gen, state, reset_buf)
        state = _replace(state, reset_buf=reset_buf, time_out_buf=time_out)

        obs = self._observations(state, measured, gen)
        state = _replace(state, last_actions=state.actions,
                         last_dof_vel=state.robot.qd[:, 6:])
        return state, LeggedStepOut(obs=obs, rew=rew, reset=reset_buf,
                                    time_outs=time_out, episode_stats=stats,
                                    num_resets=nres)

    def _observations(self, state, measured, gen):
        """(legged_robot.py:209-226)"""
        cfg = self.cfg
        sc = cfg.normalization
        robot = state.robot
        base_quat = robot.q[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 0:3])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, robot.qd[:, 3:6])
        projected_gravity = maths.quat_rotate_inverse(base_quat, self._down)
        parts = [
            base_lin_vel * sc.lin_vel,
            base_ang_vel * sc.ang_vel,
            projected_gravity,
            state.commands[:, :3] * self.commands_scale,
            (robot.q[:, 7:] - self.default_dof_pos[None]) * sc.dof_pos,
            robot.qd[:, 6:] * sc.dof_vel,
            state.actions,
        ]
        if cfg.terrain.measure_heights:
            parts.append(torch.clamp(robot.q[:, 2:3] - 0.5 - measured, -1.0,
                                     1.0) * sc.height_measurements)
        obs = torch.cat(parts, -1)
        if cfg.noise.add_noise:
            noise = torch.rand(obs.shape, generator=gen, device=self.device)
            obs = obs + (2 * noise - 1) * self.noise_vec
        return torch.clamp(obs, -sc.clip_observations, sc.clip_observations)

    def _rewards(self, state, base_lin_vel, base_ang_vel, projected_gravity,
                 measured, reset_buf, time_out):
        """All 17+1 reward terms (legged_robot.py:832-922, cassie.py:43-46);
        active set chosen by nonzero scales, scales pre-multiplied by dt."""
        cfg = self.cfg
        N = self.num_envs
        f32 = torch.float32
        robot = state.robot
        dof_pos = robot.q[:, 7:]
        dof_vel = robot.qd[:, 6:]
        torques = state.torques
        cmd = state.commands
        cmd_norm = torch.linalg.norm(cmd[:, :2], dim=1)

        # foot contact bookkeeping (legged_robot.py:898-909)
        contact = state.foot_forces[:, :, 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        air_time = state.feet_air_time + self.dt

        def collision():
            if not len(self.penalized_bodies):
                return torch.zeros(N, device=self.device)
            pen = torch.linalg.norm(
                state.body_forces[:, self.penalized_bodies], dim=-1)
            return torch.sum((pen > 0.1).to(f32), -1)

        def dof_pos_limits():
            lo, hi = self.dof_pos_limits_soft
            return torch.sum(-torch.clamp(dof_pos - lo, max=0.0)
                             + torch.clamp(dof_pos - hi, min=0.0), -1)

        def tracking_lin_vel():
            lin_err = torch.sum(
                torch.square(cmd[:, :2] - base_lin_vel[:, :2]), -1)
            return torch.exp(-lin_err / cfg.rewards.tracking_sigma)

        def tracking_ang_vel():
            ang_err = torch.square(cmd[:, 2] - base_ang_vel[:, 2])
            return torch.exp(-ang_err / cfg.rewards.tracking_sigma)

        # evaluated for the active reward names only: in eager execution
        # an unused term would still cost its kernel launches
        terms = {
            "lin_vel_z": lambda: torch.square(base_lin_vel[:, 2]),
            "ang_vel_xy": lambda: torch.sum(
                torch.square(base_ang_vel[:, :2]), -1),
            "orientation": lambda: torch.sum(
                torch.square(projected_gravity[:, :2]), -1),
            "base_height": lambda: torch.square(
                torch.mean(robot.q[:, 2:3] - measured, dim=1)
                - cfg.rewards.base_height_target),
            "torques": lambda: torch.sum(torch.square(torques), -1),
            "dof_vel": lambda: torch.sum(torch.square(dof_vel), -1),
            "dof_acc": lambda: torch.sum(
                torch.square((state.last_dof_vel - dof_vel) / self.dt), -1),
            "action_rate": lambda: torch.sum(
                torch.square(state.last_actions - state.actions), -1),
            "collision": collision,
            "termination": lambda: (reset_buf & ~time_out).to(f32),
            "dof_pos_limits": dof_pos_limits,
            "dof_vel_limits": lambda: torch.sum(torch.clamp(
                torch.abs(dof_vel) - self.dof_vel_limits
                * cfg.rewards.soft_dof_vel_limit, 0.0, 1.0), -1),
            "torque_limits": lambda: torch.sum(torch.clamp(
                torch.abs(torques) - self.torque_limits
                * cfg.rewards.soft_torque_limit, min=0.0), -1),
            "tracking_lin_vel": tracking_lin_vel,
            "tracking_ang_vel": tracking_ang_vel,
            "feet_air_time": lambda: (
                torch.sum((air_time - 0.5) * first_contact, -1)
                * (cmd_norm > 0.1)),
            "feet_stumble": lambda: torch.any(
                torch.linalg.norm(state.foot_forces[:, :, :2], dim=-1)
                > 5 * torch.abs(state.foot_forces[:, :, 2]), dim=-1).to(f32),
            "stand_still": lambda: (torch.sum(
                torch.abs(dof_pos - self.default_dof_pos[None]), -1)
                * (cmd_norm < 0.1)),
            "feet_contact_forces": lambda: torch.sum(torch.clamp(
                torch.linalg.norm(state.foot_forces, dim=-1)
                - cfg.rewards.max_contact_force, min=0.0), -1),
            # cassie: exactly one foot in contact (cassie.py:43-46)
            "no_fly": lambda: (torch.sum(contact_filt, -1) == 1).to(f32),
        }

        ep = dict(state.episode_sums)
        rew = torch.zeros(N, device=self.device)
        for k in self.reward_names:
            if k == "termination":
                continue
            r = terms[k]() * self.reward_scales[k]
            rew = rew + r
            ep[k] = ep[k] + r
        if cfg.rewards.only_positive_rewards:
            rew = torch.clamp(rew, min=0.0)
        if "termination" in self.reward_scales:
            # added after the clamp
            r = terms["termination"]() * self.reward_scales["termination"]
            rew = rew + r
            ep["termination"] = ep["termination"] + r

        # the unfiltered contact becomes last_contacts
        new_air = air_time * ~contact_filt
        return rew, ep, new_air, contact

    def reset(self, gen: torch.Generator):
        """Env-batch build + initial observation (no physics step), drawing
        from `gen` (a torch.Generator on the env's device), which the
        state keeps."""
        state = self.init_state(gen)
        if self.cfg.terrain.measure_heights:
            measured = self._measured_heights(state.robot.q)
        else:
            measured = torch.zeros((self.num_envs, 1), device=self.device)
        return state, self._observations(state, measured, gen)
