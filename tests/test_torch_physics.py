"""The port's articulated-body dynamics against the JAX package's and
against mechanics: batched `aba` (widowGo1, the box) against the JAX
`aba` (one jitted vmap), the twins of the `aba` cases of
tests/test_dynamics.py (free fall, pendulum, gravity compensation,
ABA / CRBA / RNEA consistency), widowGo1 standing under PD hold on the
unfused step (twin of tests/test_engine.py), the spatial transforms and
the maths helpers of the cold path. The unfused step against JAX's is in
tests/test_torch_unfused.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.core import urdf as jurdf
from dwbc_tpu.core.model import free_body_model as jfree_body_model
from dwbc_tpu.sim import dynamics as jdyn
from dwbc_tpu_torch.core import maths, urdf
from dwbc_tpu_torch.core.model import RobotModel, free_body_model
from dwbc_tpu_torch.sim import dynamics, engine
from dwbc_tpu_torch.terrain import terrain as terr

DEFAULT_POSE = np.array(
    [-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 0.8, -1.5]
    + [0.0] * 6 + [0.024, -0.024], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread, and no autograd bookkeeping in the substep loops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _models(name):
    if name == "box":
        return (jfree_body_model("box", 1.35, (0.05,) * 3),
                free_body_model("box", 1.35, (0.05,) * 3))
    return (jurdf.load_urdf(jurdf.WIDOW_GO1_URDF,
                            dof_order=jurdf.WIDOW_GO1_DOF_ORDER),
            urdf.load_urdf(urdf.WIDOW_GO1_URDF,
                           dof_order=urdf.WIDOW_GO1_DOF_ORDER))


def _rand_state(rng, m, n):
    q = np.zeros((n, m.nq), np.float32)
    q[:, 2] = 0.5
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = 0.3 * rng.normal(size=(n, m.nj))
    qd = (0.5 * rng.normal(size=(n, m.nv))).astype(np.float32)
    return q, qd


def _j_inert(m):
    return jdyn.default_inertial(m)


def _t_inert(m):
    return dynamics.default_inertial(m, "cpu")


@pytest.mark.parametrize("name", ["widowGo1", "box"])
def test_aba_matches_jax(name):
    """Batched port ABA against the single-env JAX ABA per env, with joint
    torques and world wrenches; rtol 1e-5 of each env's largest
    acceleration."""
    jm, m = _models(name)
    rng = np.random.default_rng(0)
    n = 4
    q, qd = _rand_state(rng, m, n)
    tau = rng.normal(size=(n, m.nj)).astype(np.float32)
    f_ext = (5.0 * rng.normal(size=(n, m.nb, 6))).astype(np.float32)
    got, kin = dynamics.aba(m, _t_inert(m), torch.as_tensor(q),
                            torch.as_tensor(qd), torch.as_tensor(tau),
                            f_ext_world=torch.as_tensor(f_ext))
    assert kin.pos.shape == (n, m.nb, 3)
    want = np.asarray(jax.jit(jax.vmap(
        lambda *a: jdyn.aba(jm, _j_inert(jm), *a[:3], f_ext_world=a[3])[0]))(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau),
            jnp.asarray(f_ext)))
    scale = np.abs(want).max(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["widowGo1", "box"])
def test_aba_singular_base_block_matches_jax(name):
    """A massless env (every body's mass and inertia zero, joint armature
    0.01) makes the base's articulated inertia IA[0] exactly zero. The
    port's batched `aba` must not raise there, and must be non-finite
    exactly where the JAX `aba` (one jitted vmap over the envs and their
    inertial parameters) is, and equal elsewhere (the test above's
    tolerance)."""
    jm, m = _models(name)
    if name == "widowGo1":
        jm = jurdf.load_urdf(jurdf.WIDOW_GO1_URDF,
                             dof_order=jurdf.WIDOW_GO1_DOF_ORDER,
                             armature=0.01)
        m = urdf.load_urdf(urdf.WIDOW_GO1_URDF,
                           dof_order=urdf.WIDOW_GO1_DOF_ORDER, armature=0.01)
    rng = np.random.default_rng(1)
    n = 3
    q, qd = _rand_state(rng, m, n)
    tau = rng.normal(size=(n, m.nj)).astype(np.float32)
    inert = [np.repeat(np.asarray(x, np.float32)[None], n, 0)
             for x in (m.mass, m.com, m.inertia)]
    inert[0][1] = 0.0
    inert[2][1] = 0.0
    got, _ = dynamics.aba(m, dynamics.Inertial(*map(torch.as_tensor, inert)),
                          torch.as_tensor(q), torch.as_tensor(qd),
                          torch.as_tensor(tau))
    want = np.asarray(jax.jit(jax.vmap(
        lambda i, *a: jdyn.aba(jm, jdyn.Inertial(*i), *a)[0]))(
            tuple(map(jnp.asarray, inert)), jnp.asarray(q), jnp.asarray(qd),
            jnp.asarray(tau)))
    finite = np.isfinite(want)
    assert not finite[1].any() and finite[[0, 2]].all()
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    scale = np.abs(want[[0, 2]]).max(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy()[[0, 2]] / scale,
                               want[[0, 2]] / scale, rtol=1e-5, atol=1e-5)


def _base_q(pos=(0, 0, 0), nj=0):
    q = torch.zeros(7 + nj)
    q[0:3] = torch.as_tensor(pos, dtype=torch.float32)
    q[6] = 1.0
    return q


def _pendulum_model(length=1.0, mass=2.0):
    """Single revolute joint about y, com at (0,0,-l): a point-mass
    pendulum hanging from the (fixed-in-place) base."""
    e = np.zeros((1,), np.float32)
    return RobotModel(
        parent=np.array([-1, 0], np.int32),
        joint_type=np.zeros((2,), np.int32),
        joint_axis=np.array([[0, 0, 0], [0, 1, 0]], np.float32),
        tree_rot=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
        tree_pos=np.zeros((2, 3), np.float32),
        mass=np.array([1e6, mass], np.float32),  # huge base ~ fixed base
        com=np.array([[0, 0, 0], [0, 0, -length]], np.float32),
        inertia=np.stack([np.eye(3, dtype=np.float32) * 1e6,
                          np.zeros((3, 3), np.float32)]),
        dof_lower=-e - 10, dof_upper=e + 10, dof_effort=e + 100,
        dof_velocity=e + 100, dof_damping=e, dof_friction=e,
        dof_armature=e,
        geom_body=np.zeros((0,), np.int32),
        geom_pos=np.zeros((0, 3), np.float32),
        geom_radius=np.zeros((0,), np.float32),
        body_names=("base", "bob"),
        dof_names=("hinge",),
        sites={},
        geom_link=(),
    )


BOX = free_body_model("box", mass=1.35, half_extents=(0.05, 0.05, 0.05))


def test_aba_free_fall():
    qdd, _ = dynamics.aba(BOX, _t_inert(BOX), _base_q((0, 0, 1.0)),
                          torch.zeros(6), torch.zeros(0))
    np.testing.assert_allclose(qdd[:3].numpy(), [0, 0, -9.81], atol=1e-5)
    np.testing.assert_allclose(qdd[3:6].numpy(), 0, atol=1e-5)


def test_aba_free_fall_with_velocity():
    """The coordinate acceleration stays -g whatever the velocity (catches
    spatial -> classical acceleration conversion faults)."""
    qd = torch.as_tensor(np.random.default_rng(0).normal(size=6),
                         dtype=torch.float32)
    qdd, _ = dynamics.aba(BOX, _t_inert(BOX), _base_q((0, 0, 1.0)), qd,
                          torch.zeros(0))
    np.testing.assert_allclose(qdd[:3].numpy(), [0, 0, -9.81], atol=1e-4)
    np.testing.assert_allclose(qdd[3:6].numpy(), 0, atol=1e-4)


def test_aba_external_force():
    f_ext = torch.zeros((1, 6))
    f_ext[0, 3:] = torch.tensor([1.35 * 9.81, 0, 1.35 * 9.81])
    qdd, _ = dynamics.aba(BOX, _t_inert(BOX), _base_q((0, 0, 1.0)),
                          torch.zeros(6), torch.zeros(0), f_ext_world=f_ext)
    np.testing.assert_allclose(qdd[:3].numpy(), [9.81, 0, 0], atol=1e-4)


def _pin_base():
    """A world force cancelling the base's weight: with the huge base
    mass the pendulum's pull on it is negligible, a fixed pivot."""
    f = torch.zeros((2, 6))
    f[0, 5] = 1e6 * 9.81
    return f


def test_aba_pendulum_acceleration():
    """theta'' = -(g/l) sin(theta) for a point-mass pendulum, four angles
    as one batch."""
    m = _pendulum_model()
    thetas = [0.0, 0.3, -0.7, 1.2]
    q = _base_q(nj=1).repeat(4, 1)
    q[:, 7] = torch.tensor(thetas)
    qdd, _ = dynamics.aba(m, _t_inert(m), q, torch.zeros((4, 7)),
                          torch.zeros((4, 1)), f_ext_world=_pin_base())
    np.testing.assert_allclose(qdd[:, 6].numpy(), -9.81 * np.sin(thetas),
                               rtol=1e-3, atol=1e-3)


def test_aba_gravity_compensation():
    """The RNEA bias torque holds the pendulum static."""
    m = _pendulum_model()
    q = _base_q(nj=1)
    q[7] = 0.6
    qd = torch.zeros(7)
    bias = dynamics.rnea_bias(m, _t_inert(m), q, qd)
    qdd, _ = dynamics.aba(m, _t_inert(m), q, qd, bias[6:7],
                          f_ext_world=_pin_base())
    assert abs(float(qdd[6])) < 1e-2


def test_aba_crba_rnea_consistency():
    """M(q) qdd + bias = tau between the three algorithms (widowGo1)."""
    _, m = _models("widowGo1")
    rng = np.random.default_rng(1)
    q, qd = (torch.as_tensor(a[0]) for a in _rand_state(rng, m, 1))
    tau = torch.as_tensor(rng.normal(size=m.nj), dtype=torch.float32)
    inert = _t_inert(m)
    qdd, kin = dynamics.aba(m, inert, q, qd, tau)
    M = dynamics.crba(m, inert, q)
    bias = dynamics.rnea_bias(m, inert, q, qd)
    R0 = kin.rot[0]
    w_b, v_b = kin.vel[0][:3], kin.vel[0][3:]
    a0 = torch.cat([R0.T @ qdd[3:6],
                    R0.T @ qdd[0:3] - torch.linalg.cross(w_b, v_b)])
    lhs = M @ torch.cat([a0, qdd[6:]]) + bias
    np.testing.assert_allclose(lhs.numpy(),
                               torch.cat([torch.zeros(6), tau]).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_aba_batch_shapes():
    _, m = _models("widowGo1")
    q = _base_q((0, 0, 0.42), nj=20).repeat(8, 1)
    qdd, _ = dynamics.aba(m, _t_inert(m), q, torch.zeros((8, 26)),
                          torch.zeros((8, 20)))
    assert qdd.shape == (8, 26) and bool(torch.isfinite(qdd).all())


def test_widowgo1_stands():
    """Dropped from the spawn height under PD hold, widowGo1 settles on the
    unfused step (physics_substep, one env, no batch dims): standing,
    level, at a plausible height, supported by its weight (twin of
    tests/test_engine.py)."""
    m = urdf.load_urdf(urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
                       armature=0.01)
    hf = terr.flat_plane(10.0, 0.5, device="cpu")
    params = engine.SimParams()
    pose = torch.as_tensor(DEFAULT_POSE)
    q0 = _base_q((0, 0, 0.42), nj=m.nj)
    q0[7:] = pose
    ctx = engine.build_ctx(m, q0)
    inert = _t_inert(m)
    kp = torch.tensor([50.0] * 12 + [5.0] * 6 + [0.0] * 2)
    kd = torch.tensor([1.0] * 12 + [0.5] * 6 + [0.0] * 2)
    state = engine.BodyState(q=q0, qd=torch.zeros(m.nv))
    fz = []
    for _ in range(600):   # 3 s
        tau = kp * (pose - state.q[7:]) - kd * state.qd[6:]
        state, con = engine.physics_substep(m, params, hf, inert, 1.0, state,
                                            tau, ctx)
        fz.append(con.geom_force[:, 2].sum())
    assert bool(torch.isfinite(state.q).all())
    assert 0.24 < float(state.q[2]) < 0.35, float(state.q[2])
    assert abs(float(state.q[6])) > 0.99
    weight = m.total_mass() * 9.81
    assert abs(float(torch.stack(fz[-100:]).mean()) - weight) < 0.3 * weight
    # the arm sags under gravity at kp = 5 but stays bounded
    assert float(state.q[7 + 12:7 + 18].abs().max()) < 0.8


def test_maths_integrate_and_identity():
    """quat_integrate against the JAX helper; quat_identity on the CPU."""
    from dwbc_tpu.core import maths as jmaths
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    got = maths.quat_integrate(torch.as_tensor(q), torch.as_tensor(w), 0.005)
    want = jmaths.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.005)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        maths.quat_identity((2, 3), device="cpu").numpy(),
        np.asarray(jmaths.quat_identity((2, 3))))
    gen = torch.Generator().manual_seed(0)
    r = maths.rand_sqrt_uniform(gen, (4096,), 0.5, 2.0, "cpu")
    assert float(r.min()) >= 0.5 and float(r.max()) <= 2.0
    # sqrt-shaped: the density piles up towards both ends
    assert float(((r - 1.25).abs() > 0.5).float().mean()) > 0.5


def test_spatial_transforms_match_jax():
    """x_motion, x_force_inv (and the inverse pairs they form) against the
    JAX helpers on random poses."""
    from dwbc_tpu.core import spatial as jspatial
    from dwbc_tpu_torch.core import spatial
    rng = np.random.default_rng(4)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = maths.quat_to_mat(torch.as_tensor(q))
    p = torch.as_tensor(rng.normal(size=(32, 3)).astype(np.float32))
    for name in ("x_motion", "x_force_inv"):
        got = getattr(spatial, name)(R, p)
        want = getattr(jspatial, name)(jnp.asarray(R.numpy()),
                                       jnp.asarray(p.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    eye = torch.eye(6).expand(32, 6, 6)
    torch.testing.assert_close(spatial.x_motion(R, p)
                               @ spatial.x_motion_inv(R, p), eye,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(spatial.x_force(R, p)
                               @ spatial.x_force_inv(R, p), eye,
                               rtol=0, atol=1e-5)
