"""Config tree for the generic legged-locomotion task family, cut to the
one robot the benchmark runs.

A typed-dataclass mirror of the reference LeggedRobotCfg
(legged_robot_config.py:33-199) and its go1 variant (go1_config.py; the
robot files are read from core/urdf.ASSETS_ROOT). PD gains / default angles are keyed by joint-name
substring exactly like the reference (legged_robot.py:536-539) and
resolved against the compiled model at env build.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

from ..core.urdf import ASSETS_ROOT

_RES = os.path.join(ASSETS_ROOT, "robots")


@dataclasses.dataclass(frozen=True)
class LeggedTerrainCfg:
    """(legged_robot_config.py:43-66)"""

    mesh_type: str = "grid"  # 'plane' | 'grid'
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    measure_heights: bool = True
    measured_points_x: Tuple[float, ...] = (
        -0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
        0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
    measured_points_y: Tuple[float, ...] = (
        -0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: Tuple[float, ...] = (0.1, 0.1, 0.35, 0.25, 0.2)


@dataclasses.dataclass(frozen=True)
class LeggedCommandsCfg:
    """(legged_robot_config.py:68-78)"""

    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4
    resampling_time: float = 10.0
    heading_command: bool = True
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-1.0, 1.0)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    heading: Tuple[float, float] = (-3.14, 3.14)


@dataclasses.dataclass(frozen=True)
class LeggedControlCfg:
    control_type: str = "P"  # P | V | T
    stiffness: Tuple[Tuple[str, float], ...] = (("joint", 20.0),)
    damping: Tuple[Tuple[str, float], ...] = (("joint", 0.5),)
    action_scale: float = 0.25
    decimation: int = 4


@dataclasses.dataclass(frozen=True)
class LeggedAssetCfg:
    file: str = ""
    dof_order: Optional[Tuple[str, ...]] = None  # None = URDF order
    foot_name: str = "foot"
    penalize_contacts_on: Tuple[str, ...] = ()
    terminate_after_contacts_on: Tuple[str, ...] = ()
    armature: float = 0.01


@dataclasses.dataclass(frozen=True)
class LeggedDomainRandCfg:
    """(legged_robot_config.py:120-127)"""

    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    friction_buckets: int = 64
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0


@dataclasses.dataclass(frozen=True)
class LeggedRewardScales:
    """(legged_robot_config.py:130-145 + robot overrides); zero = pruned."""

    termination: float = 0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -2.0
    ang_vel_xy: float = -0.05
    orientation: float = 0.0
    torques: float = -1e-5
    dof_vel: float = 0.0
    dof_acc: float = -2.5e-7
    base_height: float = 0.0
    feet_air_time: float = 1.0
    collision: float = -1.0
    feet_stumble: float = 0.0
    action_rate: float = -0.01
    stand_still: float = 0.0
    dof_pos_limits: float = 0.0
    dof_vel_limits: float = 0.0
    torque_limits: float = 0.0
    feet_contact_forces: float = 0.0
    no_fly: float = 0.0  # cassie (cassie.py:43-46)


@dataclasses.dataclass(frozen=True)
class LeggedRewardsCfg:
    scales: LeggedRewardScales = LeggedRewardScales()
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 1.0
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0


@dataclasses.dataclass(frozen=True)
class LeggedNormalizationCfg:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclasses.dataclass(frozen=True)
class LeggedNoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclasses.dataclass(frozen=True)
class LeggedInitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    default_joint_angles: Tuple[Tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class LeggedRobotCfg:
    num_envs: int = 4096
    num_actions: int = 12
    env_spacing: float = 3.0
    episode_length_s: float = 20.0
    send_timeouts: bool = True
    sim_dt: float = 0.005

    terrain: LeggedTerrainCfg = LeggedTerrainCfg()
    commands: LeggedCommandsCfg = LeggedCommandsCfg()
    control: LeggedControlCfg = LeggedControlCfg()
    asset: LeggedAssetCfg = LeggedAssetCfg()
    domain_rand: LeggedDomainRandCfg = LeggedDomainRandCfg()
    rewards: LeggedRewardsCfg = LeggedRewardsCfg()
    normalization: LeggedNormalizationCfg = LeggedNormalizationCfg()
    noise: LeggedNoiseCfg = LeggedNoiseCfg()
    init_state: LeggedInitStateCfg = LeggedInitStateCfg()

    @property
    def dt(self) -> float:
        return self.control.decimation * self.sim_dt

    @property
    def max_episode_length(self) -> int:
        return int(math.ceil(self.episode_length_s / self.dt))

    @property
    def num_height_points(self) -> int:
        return (len(self.terrain.measured_points_x)
                * len(self.terrain.measured_points_y))

    @property
    def num_observations(self) -> int:
        base = 3 + 3 + 3 + 3 + 2 * self.num_actions + self.num_actions
        if self.terrain.measure_heights:
            base += self.num_height_points
        return base


# ---------------------------------------------------------------------------
# per-robot variants

_GO1_ANGLES = (
    ("FL_hip_joint", 0.1), ("RL_hip_joint", 0.1),
    ("FR_hip_joint", -0.1), ("RR_hip_joint", -0.1),
    ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
    ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0),
    ("FL_calf_joint", -1.5), ("RL_calf_joint", -1.5),
    ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.5),
)


def go1_rough() -> LeggedRobotCfg:
    """(go1_config.py)"""
    return LeggedRobotCfg(
        init_state=LeggedInitStateCfg(pos=(0, 0, 0.42),
                                      default_joint_angles=_GO1_ANGLES),
        control=LeggedControlCfg(stiffness=(("joint", 20.0),),
                                 damping=(("joint", 0.5),), action_scale=0.25),
        asset=LeggedAssetCfg(
            file=os.path.join(_RES, "go1/urdf/go1.urdf"),
            foot_name="foot",
            penalize_contacts_on=("thigh", "calf"),
            terminate_after_contacts_on=("base",)),
        rewards=LeggedRewardsCfg(
            scales=LeggedRewardScales(
                tracking_lin_vel=1.0, tracking_ang_vel=0.5, lin_vel_z=-2.0,
                ang_vel_xy=-0.05, torques=-0.0005, dof_acc=0.0,
                feet_air_time=0.0, collision=0.0, action_rate=0.0),
            only_positive_rewards=False, base_height_target=0.25),
    )
