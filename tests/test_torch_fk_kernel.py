"""The fused substep's FK op (ops/fk_kernel.fk): on the CPU it is the
plain version (sim/fk.fused_fk), held here against the independent
sim/dynamics.fk and, through make_fused_substep's `fk`, bit for bit
against the per-body loop the substep ran before the op (kept below as
`loop_fk`); on the card it launches csrc/fk.cu, held against the plain
version on the same CUDA tensors (tests marked `cuda`).

States are random_aba_state's: base poses and velocities, joints up to
0.3 rad past their limits, resting and fast joints. Tolerance: relative
1e-5 (norm of the difference over the reference's norm), float32 rounding
of two orders of the same products; dynamics.fk builds the joint
rotations through quaternions, the op through the axis-angle formula.
On the card the kernel also reproduces the eager products' rounding, so
at the benchmark's shapes (4,096 and 5,000 envs) its outputs equal the
plain version's bit for bit.
"""

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.core import maths
from dwbc_tpu_torch.ops.fk_kernel import NB_MAX, check_limits, fk
from dwbc_tpu_torch.sim import dynamics, engine, fused
from dwbc_tpu_torch.sim.engine import SimParams
from dwbc_tpu_torch.sim.fk import fused_fk
from dwbc_tpu_torch.sim.tree import _mtv, _mv, joint_frame, tree_const
from dwbc_tpu_torch.terrain import terrain as terr
from dwbc_tpu_torch.utils import spans
from dwbc_tpu_torch.utils.measure import (ABA_TREES, aba_model, fk_bytes,
                                          random_aba_state)

RTOL = 1e-5


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def loop_fk(tc, q, qd=None):
    """The fused substep's FK as it ran before the op: per-body lists."""
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
            v.append(torch.cat([w_i, u_i], -1)
                     + tc.S[i] * qd[:, 5 + i, None])
    return R, p, v


@pytest.fixture(scope="module", params=ABA_TREES)
def robot(request):
    return (request.param, *aba_model(request.param))


def state(m, n, seed, device="cpu"):
    s = random_aba_state(m, n, seed=seed)
    return (torch.as_tensor(s["q"], device=device),
            torch.as_tensor(s["qd"], device=device))


@pytest.mark.parametrize("with_qd", [True, False])
def test_cpu_op_is_the_plain_fk_and_matches_dynamics(robot, with_qd):
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cpu")
    q, qd = state(m, 64, seed=1)
    arg = qd if with_qd else None

    launches = spans.total("fk_kernel")
    rec = spans.begin_iteration(0)
    try:
        R, p, v = fk(tc, q, arg)
    finally:
        spans.end_iteration()
    assert spans.total("fk_kernel") == launches
    assert "fk_kernel" not in rec["counters"]
    want = fused_fk(tc, q, arg)
    assert torch.equal(R, want[0]) and torch.equal(p, want[1])
    assert R.shape == (m.nb, 64, 3, 3) and p.shape == (m.nb, 64, 3)
    if with_qd:
        assert v.shape == (m.nb, 64, 6) and torch.equal(v, want[2])
    else:
        assert v is None and want[2] is None

    kin = dynamics.fk(m, q, qd)
    assert rel(R, kin.rot.transpose(0, 1)) < RTOL
    assert rel(p, kin.pos.transpose(0, 1)) < RTOL
    if with_qd:
        assert rel(v, kin.vel.transpose(0, 1)) < RTOL


@pytest.fixture(scope="module")
def substep(robot):
    """make_fused_substep of the tree on a flat plane, its FK's tree."""
    _, m, i_eff = robot
    ng = len(m.geom_body)
    ctx = engine.PhysCtx(m_solo=torch.ones(ng), m_body=torch.ones(ng),
                         dof_i_eff=i_eff, w_geom=torch.zeros((ng, 3, 3)))
    step = fused.make_fused_substep(m, SimParams(),
                                    terr.flat_plane(device="cpu"), ctx,
                                    [0], device="cpu")
    return step, tree_const(m, SimParams(), i_eff, "cpu"), m


@pytest.mark.parametrize("with_qd", [True, False])
def test_fused_substep_fk_is_the_loop_stacked(substep, with_qd):
    step, tc, m = substep
    q, qd = state(m, 33, seed=2)
    arg = qd if with_qd else None
    R, p, v = step.fk(q, arg)
    R0, p0, v0 = loop_fk(tc, q, arg)
    assert torch.equal(R, torch.stack(R0))
    assert torch.equal(p, torch.stack(p0))
    if with_qd:
        assert torch.equal(v, torch.stack(v0))
    else:
        assert v is None


def test_fused_step_calls_the_op_per_substep_and_for_the_terrain(monkeypatch):
    """One policy step of n substeps runs FK n + 1 times: once a substep
    with qd, once without for the terrain's tangent planes."""
    m, _ = aba_model("go1")
    q_ref = np.zeros(m.nq, np.float32)
    q_ref[6] = 1.0
    ctx = engine.build_ctx(m, torch.as_tensor(q_ref))
    step = fused.make_fused_substep(m, SimParams(),
                                    terr.flat_plane(device="cpu"), ctx,
                                    [0], device="cpu")
    calls = []
    plain = fused.fk_kernel.fk

    def counted(tc, q, qd=None):
        calls.append(qd is not None)
        return plain(tc, q, qd)

    monkeypatch.setattr(fused.fk_kernel, "fk", counted)
    n = 4
    q, qd = state(m, n, seed=3)
    q[:, 2] += 0.5
    mass = torch.as_tensor(np.tile(m.mass, (n, 1)), dtype=torch.float32)
    com = torch.as_tensor(np.tile(m.com, (n, 1, 1)), dtype=torch.float32)
    inertia = torch.as_tensor(np.tile(m.inertia, (n, 1, 1, 1)),
                              dtype=torch.float32)
    out = step(q, qd, lambda q_, qd_: torch.zeros((n, m.nj)), mass, com,
               inertia, torch.ones(n), 3)
    assert calls == [False, True, True, True]
    assert bool(torch.isfinite(out.q).all())


def test_op_rejects_unsupported_device(robot):
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cpu")
    q, qd = state(m, 4, seed=4)
    with pytest.raises(ValueError):
        fk(tc, q.to("meta"), qd.to("meta"))


@pytest.mark.parametrize("nb, n", [(0, 5000), (NB_MAX + 1, 5000),
                                   (21, 0), (21, 2 ** 32 // (9 * 21) + 1),
                                   (NB_MAX, 2 ** 32 // (9 * NB_MAX) + 1)])
def test_kernel_limits_raise_before_launch(nb, n):
    check_limits(NB_MAX, 2 ** 32 // (9 * NB_MAX))
    check_limits(21, 5000)
    with pytest.raises(ValueError):
        check_limits(nb, n)


@pytest.mark.parametrize("with_qd", [True, False])
def test_fk_bytes_counts_inputs_and_outputs(with_qd):
    # 21 bodies x 5000 envs with qd: 8.6 MB (csrc/fk.cu's note)
    got = fk_bytes(21, 5000, with_qd)
    floats = 5000 * 27 + 21 * 28 + 21 * 5000 * 12
    if with_qd:
        floats += 5000 * 26 + 21 * 5000 * 6
    assert got == 4 * floats


@pytest.mark.cuda
@pytest.mark.parametrize("with_qd", [True, False])
@pytest.mark.parametrize("n", [5, 4096, 5000])
def test_cuda_kernel_matches_plain_fk(robot, n, with_qd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cuda")
    q, qd = state(m, n, seed=n, device="cuda")
    arg = qd if with_qd else None
    want = fused_fk(tc, q, arg)
    launches = spans.total("fk_kernel")
    got = fk(tc, q, arg)
    torch.cuda.synchronize()
    assert spans.total("fk_kernel") == launches + 1
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert rel(g, w) < RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("with_qd", [True, False])
@pytest.mark.parametrize("n", [4096, 5000])
def test_cuda_poses_equal_the_eager_ones_bit_for_bit(robot, n, with_qd):
    """At the benchmark's shapes the kernel rounds as the eager products
    do (csrc/fk.cu, Numerics): poses and velocities are the plain
    version's exactly, so a contact or terrain sample never lands on the
    other side of a discontinuity from the eager FK's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cuda")
    q, qd = state(m, n, seed=n + 1, device="cuda")
    arg = qd if with_qd else None
    R, p, v = fk(tc, q, arg)
    R0, p0, v0 = fused_fk(tc, q, arg)
    assert torch.equal(R, R0) and torch.equal(p, p0)
    assert (v is None and v0 is None) or torch.equal(v, v0)
