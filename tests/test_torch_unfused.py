"""The port's unfused batched step (sim/engine.py: the per-env compliant
`terrain_contact`, `physics_substep`, `make_batched_step`) against the
JAX package's vmapped step, for the box and go1 on a slope, and the twins
of tests/test_engine.py's contact scenes (a dropped box rests; friction
holds a box on a slope). The JAX step is jitted once per model (seconds
on the CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.core import urdf as jurdf
from dwbc_tpu.core.model import free_body_model as jfree_body_model
from dwbc_tpu.envs import legged_config as jlc
from dwbc_tpu.sim import dynamics as jdyn
from dwbc_tpu.sim import engine as jengine
from dwbc_tpu.terrain import terrain as jterr
from dwbc_tpu_torch.core import urdf
from dwbc_tpu_torch.core.model import free_body_model
from dwbc_tpu_torch.envs import legged_config as lc
from dwbc_tpu_torch.sim import dynamics, engine
from dwbc_tpu_torch.terrain import terrain as terr

GO1_POSE = np.array([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5,
                     -0.1, 0.8, -1.5, 0.1, 0.8, -1.5], np.float32)


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
    a, b = jlc.go1_flat().asset, lc.go1_flat().asset
    return (jurdf.load_urdf(a.file, dof_order=a.dof_order,
                            armature=a.armature),
            urdf.load_urdf(b.file, dof_order=b.dof_order,
                           armature=b.armature))


def _slope_heights():
    x = np.arange(41) * 0.25 - 5.0   # world x; h = 0 at x = 0
    return np.tile(x[:, None] * 0.36, (1, 41)).astype(np.float32)


def _slope(device="cpu"):
    return terr.heightfield_from_numpy(_slope_heights(), 0.25, (-5.0, -5.0),
                                       device)


@pytest.mark.parametrize("name", ["box", "go1"])
def test_batched_step_matches_jax(name):
    """make_batched_step against the JAX package's vmapped
    physics_substep, 4 envs, 2 substeps, on a slope with spheres in
    contact: the active set equal, state, geom forces and body wrenches
    within atol 1e-4 (+ rtol 1e-4)."""
    jm, m = _models(name)
    rng = np.random.default_rng(2)
    n = 4
    q = np.zeros((n, m.nq), np.float32)
    q[:, 6] = 1.0
    q[:, 0:2] = rng.uniform(-0.5, 0.5, size=(n, 2))
    if name == "box":
        q[:, 2] = 0.045 + 0.36 * q[:, 0]
        q_ref = q[0]
    else:
        q[:, 7:] = GO1_POSE + 0.1 * rng.normal(size=(n, 12))
        q[:, 2] = 0.31 + 0.36 * q[:, 0]
        q_ref = np.concatenate([[0, 0, 0.34, 0, 0, 0, 1], GO1_POSE])
    qd = (0.3 * rng.normal(size=(n, m.nv))).astype(np.float32)
    tau = (2.0 * rng.normal(size=(n, m.nj))).astype(np.float32)
    friction = rng.uniform(0.5, 1.25, n).astype(np.float32)

    step = engine.make_batched_step(m, engine.SimParams(), _slope(),
                                    torch.as_tensor(q_ref))
    inert = dynamics.default_inertial(m, "cpu")
    state = engine.BodyState(q=torch.as_tensor(q), qd=torch.as_tensor(qd))
    # the JAX step gets the port's effective masses (equal at rtol 1e-5,
    # tests/test_torch_engine.py): the JAX build_ctx takes ~15 s eagerly
    jctx = jengine.PhysCtx(*(jnp.asarray(t.numpy()) for t in
                             engine.build_ctx(m, torch.as_tensor(q_ref))))
    jhf = jterr.Heightfield(height=jnp.asarray(_slope_heights()), cell=0.25,
                            origin=(-5.0, -5.0))
    params = jengine.SimParams()
    jstep = jax.jit(jax.vmap(lambda s, t, i, f: jengine.physics_substep(
        jm, params, jhf, i, f, s, t, jctx)))
    jinert = jax.tree.map(lambda x: jnp.tile(x[None], (n,) + (1,) * x.ndim),
                          jdyn.default_inertial(jm))
    jstate = jengine.BodyState(q=jnp.asarray(q), qd=jnp.asarray(qd))
    for _ in range(2):
        state, con = step(state, torch.as_tensor(tau), inert,
                          torch.as_tensor(friction))
        jstate, jcon = jstep(jstate, jnp.asarray(tau), jinert,
                             jnp.asarray(friction))
    assert bool((con.penetration < 0).any()), "no sphere in contact"
    np.testing.assert_array_equal(con.penetration.numpy() < 0,
                                  np.asarray(jcon.penetration) < 0)
    for a, b in ((state.q, jstate.q), (state.qd, jstate.qd),
                 (con.geom_force, jcon.geom_force),
                 (con.body_wrench, jcon.body_wrench),
                 (con.geom_pos, jcon.geom_pos)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def _box_run(hf, z0, steps, mu):
    """`steps` substeps of one box per friction coefficient in `mu`
    (make_batched_step at N = len(mu)): the state and the first box's
    base height after each substep."""
    m = free_body_model("box", 1.0, (0.05, 0.05, 0.05))
    n = len(mu)
    q0 = torch.zeros((n, 7))
    q0[:, 6] = 1.0
    q0[:, 2] = z0
    step = engine.make_batched_step(m, engine.SimParams(), hf, q0[0])
    inert = dynamics.default_inertial(m, "cpu")
    state = engine.BodyState(q=q0, qd=torch.zeros((n, 6)))
    friction = torch.tensor(mu, dtype=torch.float32)
    zs = []
    for _ in range(steps):
        state, _ = step(state, torch.zeros((n, 0)), inert, friction)
        zs.append(state.q[0, 2])
    return state, torch.stack(zs).numpy()


def test_box_drop_rests():
    """A dropped box comes to rest on the plane without bouncing
    (restitution 0) or sinking."""
    state, zs = _box_run(terr.flat_plane(5.0, 0.5, device="cpu"), 0.3, 400,
                         [1.0])
    assert np.all(np.isfinite(zs))
    assert abs(zs[-1] - 0.05) < 0.02, zs[-1]
    assert zs.max() <= 0.301
    assert abs(float(state.qd[0, 2])) < 0.05


def test_friction_holds_on_slope():
    """A high-friction box on a 20 degree slope sticks; a frictionless one
    slides downhill (the two boxes as two envs with per-env friction)."""
    state, _ = _box_run(_slope(), 0.052, 600, [1.0, 0.02])
    travel = torch.linalg.norm(state.q[:, 0:2], dim=-1)
    assert float(travel[0]) < 0.1
    assert float(travel[1]) > 0.3
