"""URDF -> RobotModel compiler.

Replaces IsaacGym's `gym.load_asset` + asset-option machinery (reference
legged_robot.py:628-651): parses the URDF, collapses fixed joints into
their nearest moving ancestor (combining inertias), reorders dofs to a
caller-chosen canonical order, and compiles collision shapes to a static
sphere set.

Collision shape compilation:
  * sphere  -> 1 sphere
  * box     -> 8 corner spheres (radius = half the smallest half-extent,
               corners inset so the spheres stay inside the box)
  * cylinder/capsule -> 2 end spheres of the cylinder radius (mirrors
               IsaacGym replace_cylinder_with_capsule)
  * mesh    -> skipped (the only mesh colliders on our robots are arm
               links which never touch terrain; reference's PhysX loads
               them but the tasks never read their contacts)
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .model import RobotModel, Site


def _rpy_to_mat(rpy: Sequence[float]) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.eye(3), np.zeros(3)
    o = elem.find("origin")
    if o is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(v) for v in o.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in o.get("rpy", "0 0 0").split()]
    return _rpy_to_mat(rpy), xyz


class _Link:
    def __init__(self, elem):
        self.name = elem.get("name")
        self.elem = elem
        inertial = elem.find("inertial")
        if inertial is not None and inertial.find("mass") is not None:
            self.mass = float(inertial.find("mass").get("value"))
            R, p = _parse_origin(inertial)
            self.com_rot, self.com_pos = R, p
            it = inertial.find("inertia")
            ixx = float(it.get("ixx", 0)); iyy = float(it.get("iyy", 0))
            izz = float(it.get("izz", 0)); ixy = float(it.get("ixy", 0))
            ixz = float(it.get("ixz", 0)); iyz = float(it.get("iyz", 0))
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            # rotate inertia into the link frame
            self.inertia = R @ I @ R.T
        else:
            self.mass = 0.0
            self.com_rot, self.com_pos = np.eye(3), np.zeros(3)
            self.inertia = np.zeros((3, 3))
        self.collisions = elem.findall("collision")


class _Joint:
    def __init__(self, elem):
        self.name = elem.get("name")
        self.type = elem.get("type")
        self.parent = elem.find("parent").get("link")
        self.child = elem.find("child").get("link")
        self.rot, self.pos = _parse_origin(elem)
        ax = elem.find("axis")
        self.axis = (
            np.array([float(v) for v in ax.get("xyz").split()])
            if ax is not None
            else np.array([1.0, 0.0, 0.0])
        )
        lim = elem.find("limit")
        self.lower = float(lim.get("lower")) if lim is not None and lim.get("lower") else -1e9
        self.upper = float(lim.get("upper")) if lim is not None and lim.get("upper") else 1e9
        self.effort = float(lim.get("effort")) if lim is not None and lim.get("effort") else 1e9
        self.velocity = float(lim.get("velocity")) if lim is not None and lim.get("velocity") else 1e9
        dyn = elem.find("dynamics")
        self.damping = float(dyn.get("damping", 0)) if dyn is not None else 0.0
        self.friction = float(dyn.get("friction", 0)) if dyn is not None else 0.0


def load_urdf(
    path: str,
    dof_order: Optional[Sequence[str]] = None,
    armature: float = 0.0,
    collapse_fixed_joints: bool = True,
) -> RobotModel:
    """Compile a URDF file into a RobotModel.

    dof_order: canonical dof-name order (e.g. hardware order). Defaults to
    URDF appearance order. armature: added rotor inertia per dof (IsaacGym
    asset option, reference legged_robot.py:643).
    """
    tree = ET.parse(path)
    root = tree.getroot()
    links = {l.get("name"): _Link(l) for l in root.findall("link")}
    joints = [_Joint(j) for j in root.findall("joint")]
    child_of = {j.child: j for j in joints}

    # root link = the one that is never a child
    root_links = [n for n in links if n not in child_of]
    assert len(root_links) == 1, f"multiple roots: {root_links}"
    root_link = root_links[0]

    if not collapse_fixed_joints:
        raise NotImplementedError("only collapse_fixed_joints=True is supported")

    # --- find each link's merged body root and its fixed transform into it ---
    # merged_root[link] = nearest ancestor link whose parent joint moves (or root)
    merged_root: Dict[str, str] = {}
    fixed_tf: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def resolve(name: str):
        if name in merged_root:
            return merged_root[name], fixed_tf[name]
        j = child_of.get(name)
        if j is None or j.type != "fixed":
            merged_root[name] = name
            fixed_tf[name] = (np.eye(3), np.zeros(3))
        else:
            proot, (Rp, pp) = resolve(j.parent)
            R = Rp @ j.rot
            p = Rp @ j.pos + pp
            merged_root[name] = proot
            fixed_tf[name] = (R, p)
        return merged_root[name], fixed_tf[name]

    for n in links:
        resolve(n)

    moving = [j for j in joints if j.type != "fixed"]
    for j in moving:
        assert j.type in ("revolute", "prismatic", "continuous"), j.type

    if dof_order is None:
        dof_order = [j.name for j in moving]
    name_to_joint = {j.name: j for j in moving}
    assert set(dof_order) == set(name_to_joint), (
        f"dof_order mismatch: {set(dof_order) ^ set(name_to_joint)}"
    )

    # --- body list: base + one body per moving joint (in dof order) ---
    body_roots: List[str] = [root_link] + [name_to_joint[n].child for n in dof_order]
    body_of_root = {r: i for i, r in enumerate(body_roots)}

    nb = len(body_roots)
    parent = np.full((nb,), -1, np.int32)
    joint_type = np.zeros((nb,), np.int32)
    joint_axis = np.zeros((nb, 3), np.float32)
    tree_rot = np.tile(np.eye(3, dtype=np.float32), (nb, 1, 1))
    tree_pos = np.zeros((nb, 3), np.float32)
    dof_lower = np.zeros((nb - 1,), np.float32)
    dof_upper = np.zeros((nb - 1,), np.float32)
    dof_effort = np.zeros((nb - 1,), np.float32)
    dof_velocity = np.zeros((nb - 1,), np.float32)
    dof_damping = np.zeros((nb - 1,), np.float32)
    dof_friction = np.zeros((nb - 1,), np.float32)

    for i, dof_name in enumerate(dof_order):
        j = name_to_joint[dof_name]
        b = i + 1
        proot, (Rp, pp) = merged_root[j.parent], fixed_tf[j.parent]
        parent[b] = body_of_root[proot]
        joint_type[b] = 0 if j.type in ("revolute", "continuous") else 1
        joint_axis[b] = j.axis / np.linalg.norm(j.axis)
        tree_rot[b] = Rp @ j.rot
        tree_pos[b] = Rp @ j.pos + pp
        dof_lower[i], dof_upper[i] = j.lower, j.upper
        dof_effort[i], dof_velocity[i] = j.effort, j.velocity
        dof_damping[i], dof_friction[i] = j.damping, j.friction

    assert np.all(parent[1:] < np.arange(1, nb)), "bodies must be topologically sorted"

    # --- combine inertias of merged links ---
    mass = np.zeros((nb,), np.float32)
    com = np.zeros((nb, 3), np.float32)
    inertia = np.zeros((nb, 3, 3), np.float32)
    for n, l in links.items():
        b = body_of_root[merged_root[n]]
        R, p = fixed_tf[n]
        m = l.mass
        c = R @ l.com_pos + p  # com of this link in body frame
        I = R @ l.inertia @ R.T
        # accumulate: mass, first moment; inertia about body origin
        mass[b] += m
        com[b] += m * c
        cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
        inertia[b] += I + m * (cx @ cx.T)
    com = com / np.maximum(mass[:, None], 1e-12)
    # convert inertia (about origin) back to about-com
    for b in range(nb):
        c = com[b]
        cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
        inertia[b] -= mass[b] * (cx @ cx.T)

    # --- sites: every original link frame ---
    sites: Dict[str, Site] = {}
    for n in links:
        b = body_of_root[merged_root[n]]
        R, p = fixed_tf[n]
        sites[n] = Site(body=b, rot=R.astype(np.float32), pos=p.astype(np.float32))

    # --- collision geoms -> spheres ---
    geom_body: List[int] = []
    geom_pos: List[np.ndarray] = []
    geom_radius: List[float] = []
    geom_link: List[str] = []

    def add_geom(b, pos, r, link_name):
        geom_body.append(b)
        geom_pos.append(np.asarray(pos, np.float64))
        geom_radius.append(float(r))
        geom_link.append(link_name)

    for n, l in links.items():
        b = body_of_root[merged_root[n]]
        Rl, pl = fixed_tf[n]
        for col in l.collisions:
            Rc, pc = _parse_origin(col)
            R = Rl @ Rc
            p = Rl @ pc + pl
            geo = col.find("geometry")
            for s in geo:
                if s.tag == "sphere":
                    add_geom(b, p, float(s.get("radius")), n)
                elif s.tag == "box":
                    half = np.array([float(v) for v in s.get("size").split()]) / 2
                    r = 0.5 * float(half.min())
                    for sx in (-1, 1):
                        for sy in (-1, 1):
                            for sz in (-1, 1):
                                corner = (half - r) * np.array([sx, sy, sz])
                                add_geom(b, R @ corner + p, r, n)
                elif s.tag in ("cylinder", "capsule"):
                    r = float(s.get("radius"))
                    h = float(s.get("length")) / 2
                    for sz in (-1, 1):
                        end = np.array([0.0, 0.0, sz * max(h - r, 0.0)])
                        add_geom(b, R @ end + p, r, n)
                # meshes skipped (see module docstring)

    return RobotModel(
        parent=parent,
        joint_type=joint_type,
        joint_axis=joint_axis,
        tree_rot=tree_rot,
        tree_pos=tree_pos,
        mass=mass,
        com=com,
        inertia=inertia,
        dof_lower=dof_lower,
        dof_upper=dof_upper,
        dof_effort=dof_effort,
        dof_velocity=dof_velocity,
        dof_damping=dof_damping,
        dof_friction=dof_friction,
        dof_armature=np.full((nb - 1,), armature, np.float32),
        geom_body=np.asarray(geom_body, np.int32),
        geom_pos=np.asarray(geom_pos, np.float32).reshape(-1, 3),
        geom_radius=np.asarray(geom_radius, np.float32),
        body_names=tuple(body_roots),
        dof_names=tuple(dof_order),
        sites=sites,
        geom_link=tuple(geom_link),
    )


# canonical hardware dof order for the Go1 + WidowX robots: this makes the
# reference's ig<->raisim reorderings (widowGo1.py:1010-1088) the identity.
GO1_DOF_ORDER = [
    "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint",
    "FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
    "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint",
    "RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
]

WIDOW_GO1_DOF_ORDER = GO1_DOF_ORDER + [
    "widow_waist", "widow_shoulder", "widow_elbow",
    "widow_forearm_roll", "widow_wrist_angle", "widow_wrist_rotate",
    "widow_left_finger", "widow_right_finger",
]

FEET_ORDER = ["FR_foot", "FL_foot", "RR_foot", "RL_foot"]

# vendored robot descriptions (reference legged_gym/resources/robots/*):
# the URDFs are data files of the JAX package's tree, read here by path
# (nothing of that package is imported); visual mesh files are not
# vendored — the sim consumes URDF inertials and primitive collision
# geoms only.
ASSETS_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "dwbc_tpu", "assets")
WIDOW_GO1_URDF = os.path.join(ASSETS_ROOT,
                              "robots/widowGo1/urdf/widowGo1.urdf")
