"""The fused substep's ABA op (ops/aba_kernel.aba): on the CPU it is the
plain version (sim/aba.fused_aba), held here against the independent
sim/dynamics.aba; on the card it launches csrc/aba.cu, held against the
plain version on the same CUDA tensors (tests marked `cuda`).

States are random: base poses and velocities, joints up to 0.3 rad past
their limits, zero and large joint velocities, nonzero contact wrenches on
every body, per-env masses scaled by 0.8-1.2. On the card one env's bodies
are 1e-9 of their masses and inertias, so that its base block's pivots
fall under the solve's 1e-6 floor. Tolerance: relative 1e-5 (norm of the
difference over the reference's norm), float32 rounding of two orders of
the same products; dynamics.aba solves the base block by LU where the
op's Cholesky has a floor, so that comparison keeps to regular envs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.ops.aba_kernel import NB_MAX, aba, check_limits
from dwbc_tpu_torch.sim import dynamics
from dwbc_tpu_torch.sim.aba import fused_aba
from dwbc_tpu_torch.sim.engine import SimParams, _limit_torques
from dwbc_tpu_torch.sim.tree import tree_const
from dwbc_tpu_torch.utils import spans
from dwbc_tpu_torch.utils.measure import (ABA_TREES, aba_args, aba_model,
                                          random_aba_state)

RTOL = 1e-5


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.fixture(scope="module", params=ABA_TREES)
def robot(request):
    return (request.param, *aba_model(request.param))


@pytest.mark.parametrize("extra_torques", ["zeroed", "limits_and_friction"])
def test_cpu_op_is_the_plain_aba_and_matches_dynamics(robot, extra_torques):
    name, m, i_eff = robot
    params = SimParams()
    if extra_torques == "zeroed":
        zero = np.zeros(m.nj, np.float32)
        m = dataclasses.replace(m, dof_damping=zero, dof_friction=zero)
    tc = tree_const(m, params, i_eff, "cpu")
    s = random_aba_state(m, 64, seed=1, past_limits=extra_torques != "zeroed")
    args, kin, t = aba_args(m, s, "cpu")

    launches = spans.total("aba_kernel")
    rec = spans.begin_iteration(0)
    try:
        qdd, ang, lin = aba(tc, *args)
    finally:
        spans.end_iteration()
    assert spans.total("aba_kernel") == launches
    assert "aba_kernel" not in rec["counters"]
    for got, want in zip((qdd, ang, lin), fused_aba(tc, *args)):
        assert torch.equal(got, want)

    tau = t["tau"] + _limit_torques(m, t["q"], t["qd"], params,
                                    tc.i_eff)
    f_ext = torch.cat([t["bN"].permute(2, 1, 0), t["bF"].permute(2, 1, 0)],
                      -1)
    ref, _ = dynamics.aba(m, dynamics.Inertial(t["mass"], t["com"],
                                               t["inertia"]),
                          t["q"], t["qd"], tau, f_ext_world=f_ext,
                          gravity=params.gravity, kin=kin)
    assert rel(lin, ref[:, 0:3]) < RTOL
    assert rel(ang, ref[:, 3:6]) < RTOL
    assert rel(qdd, ref[:, 6:]) < RTOL


def test_op_rejects_unsupported_device(robot):
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cpu")
    args = list(aba_args(m, random_aba_state(m, 4, seed=2), "cpu")[0])
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        aba(tc, *args)


def test_tree_const_refuses_a_parent_after_its_child(robot):
    _, m, i_eff = robot
    parent = np.asarray(m.parent).copy()
    parent[3] = 5
    with pytest.raises(ValueError):
        tree_const(dataclasses.replace(m, parent=parent), SimParams(), i_eff,
                   "cpu")


@pytest.mark.parametrize("nb, n", [(NB_MAX + 1, 5000), (0, 5000),
                                   (21, 0), (21, 2 ** 32 // (36 * 21) + 1),
                                   (NB_MAX, 2 ** 32 // (36 * NB_MAX) + 1)])
def test_kernel_limits_raise_before_launch(nb, n):
    check_limits(NB_MAX, 2 ** 32 // (36 * NB_MAX))
    check_limits(21, 5000)
    with pytest.raises(ValueError):
        check_limits(nb, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 5000])
def test_cuda_kernel_matches_plain_aba(robot, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, m, i_eff = robot
    tc = tree_const(m, SimParams(), i_eff, "cuda")
    s = random_aba_state(m, n, seed=n)
    singular = n - 1 if n > 1 else None
    if singular is not None:                  # pivots under the floor
        s["mass"][singular] *= 1e-9
        s["inertia"][singular] *= 1e-9
    args, _, _ = aba_args(m, s, "cuda")
    want = fused_aba(tc, *args)
    launches = spans.total("aba_kernel")
    got = aba(tc, *args)
    torch.cuda.synchronize()
    assert spans.total("aba_kernel") == launches + 1
    keep = torch.ones(n, dtype=torch.bool, device="cuda")
    if singular is not None:
        keep[singular] = False
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert rel(g[keep], w[keep]) < RTOL
        if singular is not None:
            assert rel(g[singular], w[singular]) < RTOL
