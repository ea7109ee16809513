"""The port's OSC ingredients against MuJoCo on the widowGo1 model: the
twin of tests/test_osc_golden.py for dwbc_tpu_torch.

The arm OSC torque-supervision target (`WidowGo1Env._osc_target`) is
algebra over the arm block of the mass matrix, the EE jacobian and the
gravity bias. Each is computed by the port's batched sim/dynamics.py for
three random poses at once and compared with MuJoCo on the same exported
model, at the tolerances of the JAX package's test (rtol 1e-4; atol 1e-6
on the mass matrix and the jacobian, 1e-5 on the bias)."""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from dwbc_tpu_torch.core import urdf
from dwbc_tpu_torch.sim import dynamics

from test_contact_golden import robotmodel_to_mjcf
from test_osc_golden import ARM, _mj_at, _rand_q

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def widow():
    model = urdf.load_urdf(urdf.WIDOW_GO1_URDF,
                           dof_order=urdf.WIDOW_GO1_DOF_ORDER)
    mj = mujoco.MjModel.from_xml_string(robotmodel_to_mjcf(model))
    qs = np.stack([_rand_q(model, s) for s in SEEDS])
    q = torch.as_tensor(qs, dtype=torch.float32)
    inert = dynamics.default_inertial(model, "cpu")
    gripper = model.sites["wx250s/ee_gripper_link"].body
    offset = torch.as_tensor(
        np.asarray(model.sites["wx250s/ee_gripper_link"].pos, np.float32))
    kin = dynamics.fk(model, q, torch.zeros(len(SEEDS), model.nv))
    ours = dict(
        M=dynamics.crba(model, inert, q).numpy(),
        J=dynamics.body_jacobian(model, q, gripper, offset, kin=kin).numpy(),
        bias=dynamics.rnea_bias(model, inert, q,
                                torch.zeros(len(SEEDS), model.nv)).numpy(),
        p=(kin.pos[:, gripper]
           + (kin.rot[:, gripper] @ offset)).numpy())
    return mj, qs, gripper, ours


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_arm_mass_matrix_matches_mujoco(widow, i):
    mj, qs, _, ours = widow
    d = _mj_at(mj, qs[i])
    Mfull = np.zeros((mj.nv, mj.nv))
    mujoco.mj_fullM(mj, d, Mfull)
    np.testing.assert_allclose(ours["M"][i][ARM, ARM], Mfull[ARM, ARM],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_ee_jacobian_matches_mujoco(widow, i):
    mj, qs, gripper, ours = widow
    d = _mj_at(mj, qs[i])
    jacp = np.zeros((3, mj.nv))
    jacr = np.zeros((3, mj.nv))
    mujoco.mj_jac(mj, d, jacp, jacr, ours["p"][i].astype(np.float64),
                  gripper + 1)  # mj body 0 = world
    J = ours["J"][i]
    # joint columns are convention-independent (world-frame [lin; ang])
    np.testing.assert_allclose(J[:3, 6:], jacp[:, 6:], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(J[3:, 6:], jacr[:, 6:], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_gravity_bias_matches_mujoco(widow, i):
    mj, qs, _, ours = widow
    d = _mj_at(mj, qs[i])
    # qvel = 0: both are the generalized force that holds the pose still
    np.testing.assert_allclose(ours["bias"][i][6:], d.qfrc_bias[6:],
                               rtol=1e-4, atol=1e-5)
