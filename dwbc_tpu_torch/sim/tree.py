"""A kinematic tree's constants for the fused substep's plain versions and
kernels, and the joint frame and rotation helpers they share.

`tree_const` builds a `TreeConst` once per simulator (sim/fused.py): the
tree's structure and per-dof constants as tensors for the plain PyTorch
versions (sim/fk.py, sim/aba.py), and `table`, one float32 row per body
in the layout the CUDA kernels read (csrc/fk.cu, csrc/aba.cu).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.model import RobotModel
from ..utils.device import resolve_device

# columns of TreeConst.table, one row per body (of row 0, the base, the
# kernels read only the parent, -1): the layout csrc/aba.cu and csrc/fk.cu
# read
PARENT, PRISMATIC, AXIS, TREE_ROT, TREE_POS, PRISM_DIR = 0, 1, 2, 5, 14, 17
ARMATURE, DAMPING, FRICTION, LOWER, UPPER, I_EFF = 20, 21, 22, 23, 24, 25
TABLE_W = 28


class TreeConst(NamedTuple):
    """A kinematic tree's constants on the simulator's device."""

    nb: int
    parent: List[int]
    prismatic: List[bool]
    armature: List[float]
    S: torch.Tensor           # (nb, 6) motion subspaces in body coords
    tree_rot: torch.Tensor    # (nb, 3, 3)
    tree_pos: torch.Tensor    # (nb, 3)
    axis_outer: torch.Tensor  # (nb, 3, 3) a a^T
    axis_skew: torch.Tensor   # (nb, 3, 3) skew(a)
    prism_dir: torch.Tensor   # (nb, 3, 1) tree_rot @ a
    eye3: torch.Tensor
    damping: torch.Tensor     # (nj,) per dof
    friction: torch.Tensor
    dof_lo: torch.Tensor
    dof_hi: torch.Tensor
    i_eff: torch.Tensor
    gvec: torch.Tensor        # (3,)
    gravity: Tuple[float, float, float]
    limit_kp: float
    limit_kd: float
    dt: float
    table: torch.Tensor       # (nb, TABLE_W) float32, the kernel's copy


def tree_const(model: RobotModel, params, i_eff, device="cuda") -> TreeConst:
    """The constants of `model`'s tree for `params` (sim/engine.SimParams)
    and the joints' effective inertias `i_eff` (nj,), uploaded once to
    `device`. Raises ValueError unless every body's parent precedes it and
    every joint is revolute (0) or prismatic (1)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    nb = model.nb
    parent = [int(p) for p in model.parent]
    jtype = [int(t) for t in model.joint_type]
    if parent[0] != -1 or any(not 0 <= parent[i] < i for i in range(1, nb)):
        raise ValueError(f"tree: every body's parent must precede it, got "
                         f"{parent}")
    if any(t not in (0, 1) for t in jtype[1:]):
        raise ValueError(f"tree: joint types must be 0 or 1, got {jtype}")
    prismatic = [t == 1 for t in jtype]
    axes = np.asarray(model.joint_axis, np.float64)
    tree_rot = f32(model.tree_rot)
    # motion subspaces: [axis; 0] revolute, [0; axis] prismatic
    S = f32([np.concatenate([np.zeros(3), axes[i]]) if prismatic[i]
             else np.concatenate([axes[i], np.zeros(3)]) for i in range(nb)])
    prism_dir = tree_rot @ f32(axes)[..., None]
    tree_rot_np = np.asarray(model.tree_rot, np.float32)
    i_eff_np = np.asarray(torch.as_tensor(i_eff).cpu(), np.float32)

    table = np.zeros((nb, TABLE_W), np.float32)
    table[:, PARENT] = parent
    table[:, PRISMATIC] = prismatic
    table[:, AXIS:AXIS + 3] = axes
    table[:, TREE_ROT:TREE_ROT + 9] = tree_rot_np.reshape(nb, 9)
    table[:, TREE_POS:TREE_POS + 3] = model.tree_pos
    table[:, PRISM_DIR:PRISM_DIR + 3] = np.einsum(
        "bij,bj->bi", tree_rot_np, axes.astype(np.float32))
    for col, per_dof in ((ARMATURE, model.dof_armature),
                         (DAMPING, model.dof_damping),
                         (FRICTION, model.dof_friction),
                         (LOWER, model.dof_lower), (UPPER, model.dof_upper),
                         (I_EFF, i_eff_np)):
        table[1:, col] = per_dof
    return TreeConst(
        nb=nb, parent=parent, prismatic=prismatic,
        armature=[float(a) for a in model.dof_armature], S=S,
        tree_rot=tree_rot, tree_pos=f32(model.tree_pos),
        axis_outer=f32([np.outer(a, a) for a in axes]),
        axis_skew=f32([[[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                        [-a[1], a[0], 0.0]] for a in axes]),
        prism_dir=prism_dir, eye3=torch.eye(3, device=dev),
        damping=f32(model.dof_damping), friction=f32(model.dof_friction),
        dof_lo=f32(model.dof_lower), dof_hi=f32(model.dof_upper),
        i_eff=f32(i_eff_np), gvec=f32(params.gravity),
        gravity=tuple(float(g) for g in params.gravity),
        limit_kp=params.limit_kp, limit_kd=params.limit_kd, dt=params.dt,
        table=torch.as_tensor(table, device=dev))


def joint_frame(tc: TreeConst, i: int, qi: torch.Tensor):
    """Pose (Rj (N, 3, 3), jp (N, 3) or (3,)) of body i in its parent.
    Revolute: R(q) = c I + (1 - c) a a^T + s skew(a) after tree_rot."""
    if tc.prismatic[i]:
        return (tc.tree_rot[i].expand(qi.shape[0], 3, 3),
                tc.tree_pos[i] + tc.prism_dir[i, :, 0] * qi[:, None])
    c = torch.cos(qi)[:, None, None]
    s = torch.sin(qi)[:, None, None]
    Ra = tc.eye3 * c + tc.axis_outer[i] * (1 - c) + tc.axis_skew[i] * s
    return tc.tree_rot[i] @ Ra, tc.tree_pos[i]


def _mv(R, v):
    """R @ v over the batch: R (..., 3, 3), v (..., 3) or a constant (3,)."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def _mtv(R, v):
    return _mv(R.transpose(-1, -2), v)
