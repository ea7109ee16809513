"""The fused substep's forward kinematics, plain PyTorch version.

`fused_fk` computes the bodies' world poses of a kinematic tree from the
generalised coordinates q, and with qd their spatial velocities: a Python
loop over the bodies in tree order on batched (N, 3, 3) rotations, each
body's joint frame from `sim/tree.joint_frame`. It returns the stacks that
the contact span and the ABA op read: rotations (nb, N, 3, 3), positions
(nb, N, 3) and velocities (nb, N, 6).

It is the version that runs on CPU tensors, and the oracle of the CUDA
kernel csrc/fk.cu (ops/fk_kernel.fk is the drop-in that picks between
them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import maths
from .tree import TreeConst, _mtv, _mv, joint_frame


def fused_fk(tc: TreeConst, q: torch.Tensor, qd: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Body world rotations R (nb, N, 3, 3) and positions p (nb, N, 3) of
    the tree `tc` at q (N, nb + 6), the base's from its xyzw quaternion;
    with qd (N, nb + 5) the body spatial velocities v (nb, N, 6) [ang; lin]
    in body coordinates, else None."""
    R = [maths.quat_to_mat(q[:, 3:7])]
    p = [q[:, 0:3]]
    v = None
    if qd is not None:
        v = [torch.cat([_mtv(R[0], qd[:, 3:6]), _mtv(R[0], qd[:, 0:3])], -1)]
    for i in range(1, tc.nb):
        Rj, pj = joint_frame(tc, i, q[:, 6 + i])
        pa = tc.parent[i]
        R.append(R[pa] @ Rj)
        p.append(_mv(R[pa], pj) + p[pa])
        if qd is not None:
            wp, up = v[pa][:, :3], v[pa][:, 3:]
            w_i = _mtv(Rj, wp)
            u_i = _mtv(Rj, up + torch.linalg.cross(wp, pj.expand_as(wp)))
            v.append(torch.cat([w_i, u_i], -1) + tc.S[i] * qd[:, 5 + i, None])
    return (torch.stack(R), torch.stack(p),
            None if v is None else torch.stack(v))
