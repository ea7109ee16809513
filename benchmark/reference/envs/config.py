"""Typed dataclass config tree.

Replaces the reference's nested plain-class config system
(base_config.py:33-57 recursive instantiation + class_to_dict). Leaf
values for widowGo1 mirror widowGo1_config.py exactly (cited per field
group). Dataclasses are frozen; anything schedule-dependent is computed
from the iteration counter at each step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

_PI = math.pi


@dataclasses.dataclass(frozen=True)
class GoalEECfg:
    """EE-goal generator (widowGo1_config.py:47-82)."""

    traj_time: Tuple[float, float] = (1.0, 3.0)
    hold_time: Tuple[float, float] = (0.5, 2.0)
    collision_upper_limits: Tuple[float, float, float] = (0.3, 0.15, 0.05 - 0.165)
    collision_lower_limits: Tuple[float, float, float] = (-0.2, -0.15, -0.35 - 0.165)
    underground_limit: float = -0.57
    num_collision_check_samples: int = 10
    command_mode: str = "sphere"  # 'cart' | 'sphere'
    l_schedule: Tuple[float, float] = (0.0, 1.0)
    p_schedule: Tuple[float, float] = (0.0, 1.0)
    y_schedule: Tuple[float, float] = (0.0, 1.0)
    tracking_ee_reward_schedule: Tuple[float, float] = (0.0, 1.0)
    final_pos_l: Tuple[float, float] = (0.2, 0.7)
    final_pos_p: Tuple[float, float] = (-2 * _PI / 5, 1 * _PI / 5)
    final_pos_y: Tuple[float, float] = (-3 * _PI / 5, 3 * _PI / 5)
    init_pos_l: Tuple[float, float] = (0.6, 0.6)
    init_pos_p: Tuple[float, float] = (1 * _PI / 4, 1 * _PI / 4)
    init_pos_y: Tuple[float, float] = (-1 * _PI / 6, 1 * _PI / 6)
    final_delta_orn: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    final_tracking_ee_reward: float = 0.55
    # sphere_error_scale derived as in widowGo1_config.py:76
    @property
    def sphere_error_scale(self) -> Tuple[float, float, float]:
        return (
            1.0 / (self.final_pos_l[1] - self.final_pos_l[0]),
            1.0 / (self.final_pos_p[1] - self.final_pos_p[0]),
            1.0 / (self.final_pos_y[1] - self.final_pos_y[0]),
        )

    orn_error_scale: Tuple[float, float, float] = (2 / _PI, 2 / _PI, 2 / _PI)


@dataclasses.dataclass(frozen=True)
class CommandsCfg:
    """Velocity-command curriculum (widowGo1_config.py:84-103)."""

    resampling_time: float = 3.0
    lin_vel_x_schedule: Tuple[float, float] = (0.0, 1.0)
    ang_vel_yaw_schedule: Tuple[float, float] = (0.0, 1.0)
    tracking_ang_vel_yaw_schedule: Tuple[float, float] = (0.0, 1.0)
    ang_vel_yaw_clip: float = 0.6
    lin_vel_x_clip: float = 0.3
    final_lin_vel_x: Tuple[float, float] = (0.0, 0.9)
    final_ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    init_lin_vel_x: Tuple[float, float] = (0.0, 0.0)
    init_ang_vel_yaw: Tuple[float, float] = (0.0, 0.0)
    final_tracking_ang_vel_yaw_exp: float = 0.15


@dataclasses.dataclass(frozen=True)
class ObsScalesCfg:
    lin_vel: float = 1.0
    ang_vel: float = 1.0
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0


@dataclasses.dataclass(frozen=True)
class NormalizationCfg:
    obs_scales: ObsScalesCfg = ObsScalesCfg()
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclasses.dataclass(frozen=True)
class ControlCfg:
    """PD drive (widowGo1_config.py:162-173)."""

    stiffness: Tuple[float, ...] = (50.0,) * 12 + (5.0,) * 6
    damping: Tuple[float, ...] = (1.0,) * 12 + (0.5,) * 6
    adaptive_arm_gains: bool = False
    action_scale: Tuple[float, ...] = (
        (0.4, 0.45, 0.45) * 2 + (0.4, 0.45, 0.45) * 2 + (2.1, 0.6, 0.6, 0.0, 0.0, 0.0)
    )
    decimation: int = 4
    torque_supervision: bool = False
    # opt-in gravity-droop compensation of the leg PD targets
    # (WidowGo1Env.enable_droop_compensation); off = reference parity
    droop_compensation: bool = False


@dataclasses.dataclass(frozen=True)
class BoxCfg:
    """Free box actor (widowGo1_config.py:185-192)."""

    box_size: float = 0.1
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-0.001, 0.050)
    box_env_origins_x: float = 0.0
    box_env_origins_y_range: Tuple[float, float] = (0.1, 0.3)
    box_env_origins_z: float = 0.1 / 2 + 0.16
    density: float = 1000.0


@dataclasses.dataclass(frozen=True)
class ArmCfg:
    """OSC expert gains (widowGo1_config.py:194-198)."""

    osc_kp: Tuple[float, ...] = (100.0, 100.0, 100.0, 30.0, 30.0, 30.0)
    grasp_offset: float = 0.08

    @property
    def osc_kd(self) -> Tuple[float, ...]:
        return tuple(2.0 * math.sqrt(k) for k in self.osc_kp)


@dataclasses.dataclass(frozen=True)
class DomainRandCfg:
    """DR ranges (widowGo1_config.py:200-225)."""

    observe_priv: bool = True
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (-0.5, 3.0)
    friction_buckets: int = 1000
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-0.5, 2.5)
    randomize_base_com: bool = True
    added_com_range_x: Tuple[float, float] = (-0.15, 0.15)
    added_com_range_y: Tuple[float, float] = (-0.15, 0.15)
    added_com_range_z: Tuple[float, float] = (-0.15, 0.15)
    randomize_motor: bool = True
    leg_motor_strength_range: Tuple[float, float] = (0.7, 1.3)
    arm_motor_strength_range: Tuple[float, float] = (0.7, 1.3)
    randomize_gripper_mass: bool = True
    gripper_added_mass_range: Tuple[float, float] = (0.0, 0.1)
    # full inertia-tensor DR (no reference analogue; guarded against the
    # Pallas path, which bakes inertials — widowgo1.py DWBC_PALLAS check)
    randomize_inertia: bool = False
    push_robots: bool = True
    push_interval_s: float = 3.0
    max_push_vel_xy: float = 0.5


@dataclasses.dataclass(frozen=True)
class RewardScalesCfg:
    """Leg reward scales — the FULL selectable surface of the reference
    (widowGo1_config.py:231-258: every `_reward_*` reachable through the
    reflection in _prepare_reward_function, including the LeggedRobot base
    terms). Zero scales are pruned at build time like the reference; any
    scale here can be made nonzero without code changes."""

    # active in the released config (widowGo1_config.py:238-258)
    energy_square: float = -6e-5
    survive: float = 0.2
    tracking_lin_vel_x_l1: float = 0.5
    tracking_ang_vel_yaw_exp: float = 0.15  # curriculum-driven
    hip_action_l2: float = -0.01
    foot_contacts_z: float = -1e-4
    # zero-by-default selectable terms (widowGo1_config.py:231-257 +
    # base legged_robot.py:832-922 via reflection)
    termination: float = 0.0
    tracking_lin_vel: float = 0.0
    tracking_ang_vel: float = 0.0
    lin_vel_z: float = 0.0
    ang_vel_xy: float = 0.0
    orientation: float = 0.0
    torques: float = 0.0
    dof_vel: float = 0.0
    dof_acc: float = 0.0
    base_height: float = 0.0
    feet_air_time: float = 0.0
    collision: float = 0.0
    feet_stumble: float = 0.0
    action_rate: float = 0.0
    stand_still: float = 0.0
    leg_energy: float = 0.0
    leg_energy_abs_sum: float = 0.0
    leg_energy_sum_abs: float = 0.0  # widowGo1.py:1401 (fn w/o cfg entry)
    tracking_lin_vel_x_exp: float = 0.0
    tracking_ang_vel_yaw_l1: float = 0.0
    tracking_lin_vel_y_l2: float = 0.0
    tracking_lin_vel_z_l2: float = 0.0
    leg_action_l2: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArmRewardScalesCfg:
    """Arm reward scales (widowGo1_config.py:259-266). `arm_orientation`
    is omitted: its reward fn is commented out in the reference
    (widowGo1.py:1417-1421), so enabling it there would crash — it is not
    part of the capability surface."""

    tracking_ee_sphere: float = 0.55  # curriculum-driven
    arm_energy_abs_sum: float = -0.0040
    termination: float = 0.0
    tracking_ee_cart: float = 0.0  # curriculum-driven when command_mode='cart'
    tracking_ee_orn: float = 0.0
    tracking_ee_orn_ry: float = 0.0


@dataclasses.dataclass(frozen=True)
class RewardsCfg:
    scales: RewardScalesCfg = RewardScalesCfg()
    arm_scales: ArmRewardScalesCfg = ArmRewardScalesCfg()
    only_positive_rewards: bool = False
    tracking_sigma: float = 1.0
    tracking_ee_sigma: float = 1.0
    soft_dof_pos_limit: float = 1.0
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.25
    max_contact_force: float = 100.0


@dataclasses.dataclass(frozen=True)
class AssetCfg:
    """Contact body lists (widowGo1_config.py:175-183). The released
    reference has terminate_after_contacts_on = [] (contact termination a
    no-op), with ["wx250", "base"] left commented as the intended set."""

    penalize_contacts_on: Tuple[str, ...] = ("thigh", "trunk")
    terminate_after_contacts_on: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class TerminationCfg:
    """(widowGo1_config.py:284-287)"""

    r_threshold: float = 0.78  # NOTE: check_termination uses 0.2 literals
    p_threshold: float = 0.60  # (widowGo1.py:945-946); we mirror behavior
    z_threshold: float = 0.325


@dataclasses.dataclass(frozen=True)
class TerrainCfg:
    """(widowGo1_config.py:289-315)"""

    mesh_type: str = "perlin"  # 'plane' | 'perlin' | 'grid'
    horizontal_scale: float = 0.025
    tot_cols: int = 600
    tot_rows: int = 10000
    z_scale: float = 0.15
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    measure_heights: bool = False
    origin_perturb_range: float = 0.5
    init_vel_perturb_range: float = 0.1


@dataclasses.dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = False
    noise_level: float = 1.0
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclasses.dataclass(frozen=True)
class EnvCfg:
    """(widowGo1_config.py:116-131)"""

    num_envs: int = 5000
    num_actions: int = 18
    num_torques: int = 18
    action_delay: int = 2
    num_proprio: int = 2 + 3 + 20 + 20 + 18 + 4 + 3 + 3 + 3  # 76
    num_priv: int = 5 + 1 + 18  # 24
    history_len: int = 10
    episode_length_s: float = 10.0
    send_timeouts: bool = True

    @property
    def num_observations(self) -> int:
        return self.num_proprio * (self.history_len + 1) + self.num_priv


@dataclasses.dataclass(frozen=True)
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.42)
    # default angles in HARDWARE dof order (FR,FL,RR,RL × hip/thigh/calf,
    # then arm, then fingers) — values from widowGo1_config.py:135-160
    default_joint_angles: Tuple[float, ...] = (
        -0.1, 0.8, -1.5,   # FR
        0.1, 0.8, -1.5,    # FL
        -0.1, 0.8, -1.5,   # RR
        0.1, 0.8, -1.5,    # RL
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0,  # arm
        0.015, -0.015,     # fingers (clamped into URDF limits)
    )


@dataclasses.dataclass(frozen=True)
class SimCfg:
    dt: float = 0.005
    armature: float = 0.01  # explicit integrator needs real rotor inertia


@dataclasses.dataclass(frozen=True)
class WidowGo1Cfg:
    env: EnvCfg = EnvCfg()
    asset: AssetCfg = AssetCfg()
    goal_ee: GoalEECfg = GoalEECfg()
    commands: CommandsCfg = CommandsCfg()
    normalization: NormalizationCfg = NormalizationCfg()
    control: ControlCfg = ControlCfg()
    box: BoxCfg = BoxCfg()
    arm: ArmCfg = ArmCfg()
    domain_rand: DomainRandCfg = DomainRandCfg()
    rewards: RewardsCfg = RewardsCfg()
    termination: TerminationCfg = TerminationCfg()
    terrain: TerrainCfg = TerrainCfg()
    noise: NoiseCfg = NoiseCfg()
    init_state: InitStateCfg = InitStateCfg()
    sim: SimCfg = SimCfg()

    @property
    def dt(self) -> float:  # policy dt
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        return int(math.ceil(self.env.episode_length_s / self.dt))
