"""Static robot model: the ahead-of-time compiled kinematic tree.

The reference builds its scene by looping `gym.create_actor` 5000 times
against the PhysX binary (reference widowGo1.py:355-392). Here the URDF is
compiled ONCE into a static array-of-structs pytree shared by every env;
per-env domain randomization lives in separate vectors (see envs/), never
in per-env physics objects.

Conventions:
  * body 0 is the floating base; every other body has exactly one dof
    (revolute or prismatic) connecting it to its parent — fixed joints are
    collapsed at compile time (mirroring IsaacGym collapse_fixed_joints,
    reference legged_robot.py:634).
  * dof index of body i is i-1; the dof order is chosen by the caller
    (we use real-robot "hardware order", which makes the reference's
    ig2raisim permutations (widowGo1.py:1010-1088) the identity).
  * collision geometry is compiled to a static set of spheres
    (body_idx, offset, radius) for O(1) heightfield contact tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Site:
    """A named frame welded to a body (e.g. foot center, EE gripper)."""

    body: int
    rot: np.ndarray  # (3,3) site frame in body frame
    pos: np.ndarray  # (3,)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Immutable compiled model. All arrays are numpy; the simulator turns
    the ones it needs into float32 device tensors when it is built."""

    # --- tree topology (nb bodies; body 0 = floating base) ---
    parent: np.ndarray        # (nb,) int, parent[0] = -1
    joint_type: np.ndarray    # (nb,) int: 0=revolute, 1=prismatic (body 0 unused)
    joint_axis: np.ndarray    # (nb, 3) axis in child body frame
    tree_rot: np.ndarray      # (nb, 3, 3) joint frame in parent body frame
    tree_pos: np.ndarray      # (nb, 3)

    # --- inertial (body frame) ---
    mass: np.ndarray          # (nb,)
    com: np.ndarray           # (nb, 3)
    inertia: np.ndarray       # (nb, 3, 3) about com, body frame

    # --- per-dof properties (nj = nb - 1) ---
    dof_lower: np.ndarray     # (nj,)
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_velocity: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    dof_armature: np.ndarray

    # --- collision spheres ---
    geom_body: np.ndarray     # (ng,) int
    geom_pos: np.ndarray      # (ng, 3) offset in body frame
    geom_radius: np.ndarray   # (ng,)

    # --- names / lookup ---
    body_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]
    sites: Dict[str, Site]
    geom_link: Tuple[str, ...]  # source URDF link name per geom

    @property
    def nb(self) -> int:
        return int(self.parent.shape[0])

    @property
    def nj(self) -> int:
        return self.nb - 1

    @property
    def nq(self) -> int:
        """Generalized position dim: base pos(3) + quat(4) + joints."""
        return 7 + self.nj

    @property
    def nv(self) -> int:
        """Generalized velocity dim: base(6) + joints."""
        return 6 + self.nj

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def dof_index(self, name: str) -> int:
        return self.dof_names.index(name)

    def geoms_of(self, substr: str) -> np.ndarray:
        """Indices of collision geoms whose source link name contains substr."""
        return np.array(
            [i for i, n in enumerate(self.geom_link) if substr in n], dtype=np.int32
        )

    def total_mass(self) -> float:
        return float(self.mass.sum())


def free_body_model(name: str, mass: float, half_extents, inertia_diag=None) -> RobotModel:
    """A single free rigid body (e.g. the reference's 0.1 m box actor,
    widowGo1.py:320-325): box collision compiled to 8 corner spheres."""
    hx, hy, hz = [float(h) for h in half_extents]
    if inertia_diag is None:
        # solid box inertia
        ix = mass / 3.0 * (hy * hy + hz * hz)
        iy = mass / 3.0 * (hx * hx + hz * hz)
        iz = mass / 3.0 * (hx * hx + hy * hy)
        inertia_diag = (ix, iy, iz)
    r = 0.5 * min(hx, hy, hz)
    corners = np.array(
        [[sx * (hx - r), sy * (hy - r), sz * (hz - r)]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float32,
    )
    e = np.zeros((0,), np.float32)
    return RobotModel(
        parent=np.array([-1], np.int32),
        joint_type=np.zeros((1,), np.int32),
        joint_axis=np.zeros((1, 3), np.float32),
        tree_rot=np.eye(3, dtype=np.float32)[None],
        tree_pos=np.zeros((1, 3), np.float32),
        mass=np.array([mass], np.float32),
        com=np.zeros((1, 3), np.float32),
        inertia=np.diag(np.asarray(inertia_diag, np.float32))[None],
        dof_lower=e, dof_upper=e, dof_effort=e, dof_velocity=e,
        dof_damping=e, dof_friction=e, dof_armature=e,
        geom_body=np.zeros((8,), np.int32),
        geom_pos=corners,
        geom_radius=np.full((8,), r, np.float32),
        body_names=(name,),
        dof_names=(),
        sites={},
        geom_link=(name,) * 8,
    )
