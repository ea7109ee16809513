"""One decimation-4 physics step of widowGo1 with the co-simulated box,
port against the JAX package, from the same state, carry, torque law and
physics context, on a small Perlin heightfield.

The JAX step runs eagerly (jax.disable_jit, substeps unrolled): the same
functions as the compiled path without minutes of XLA compile. Tolerance:
atol 1e-4 on q, qd and the box state — the fused-vs-dynamics tolerance of
the JAX package (sim/fused.py:18); the warm-start contact carries (forces
up to tens of newtons) at atol 1e-4 plus rtol 1e-5, float32 round-off
through four substeps of impulse law whose corrections scale velocity
errors by m/dt.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.core import urdf as jurdf
from dwbc_tpu.sim import engine as jengine
from dwbc_tpu.sim import fused as jfused
from dwbc_tpu.terrain import terrain as jterr
from dwbc_tpu_torch.core import urdf
from dwbc_tpu_torch.envs.config import WidowGo1Cfg
from dwbc_tpu_torch.sim import engine, fused
from dwbc_tpu_torch.terrain import terrain as terr

N = 16
KP, KD = 20.0, 0.5


@pytest.fixture(scope="module")
def scene():
    cfg = WidowGo1Cfg()
    jm = jurdf.load_urdf(jurdf.WIDOW_GO1_URDF,
                         dof_order=jurdf.WIDOW_GO1_DOF_ORDER,
                         armature=cfg.sim.armature)
    m = urdf.load_urdf(urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
                       armature=cfg.sim.armature)
    default = np.asarray(cfg.init_state.default_joint_angles, np.float32)
    q_ref = np.zeros(m.nq, np.float32)
    q_ref[6] = 1.0
    q_ref[2] = cfg.init_state.pos[2]
    q_ref[7:] = default
    jctx = jengine.build_ctx(jm, jnp.asarray(q_ref))
    # the port steps with the JAX context: build_ctx parity is its own test
    ctx = engine.PhysCtx(*(torch.as_tensor(np.array(getattr(jctx, f)))
                           for f in engine.PhysCtx._fields))
    h = terr.perlin_heights(terr.PerlinTerrainCfg(
        horizontal_scale=0.025, tot_cols=600, tot_rows=400, seed=3))
    # the wall fence starts at row 200 (x = 0): the robots stand before it
    origin = (-5.0, -5.0)
    jhf = jterr.Heightfield(height=jnp.asarray(h), cell=0.025, origin=origin)
    hf = terr.heightfield_from_numpy(h, 0.025, origin, "cpu")
    feet = np.concatenate([m.geoms_of(f) for f in urdf.FEET_ORDER])
    box = (0.05,) * 3

    rng = np.random.default_rng(0)
    f32 = np.float32
    q = np.tile(q_ref, (N, 1))
    q[:, 0] = rng.uniform(-4.0, -1.5, N)
    q[:, 1] = rng.uniform(-3.0, 3.0, N)
    ground = np.asarray(jhf.sample(jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1])))
    q[:, 2] = ground + rng.uniform(0.28, 0.36, N)   # feet in and near contact
    q[:, 7:] += rng.normal(0, 0.1, (N, m.nj))
    box_q = np.zeros((N, 7), f32)
    box_q[:, 0] = q[:, 0] + 0.1
    box_q[:, 1] = q[:, 1] + rng.uniform(-0.2, 0.2, N)
    box_q[:, 2] = ground + 0.05
    box_q[:, 6] = 1.0
    inputs = dict(
        q=q.astype(f32), qd=rng.normal(0, 0.3, (N, m.nv)).astype(f32),
        mass=np.tile(m.mass, (N, 1)), com=np.tile(m.com, (N, 1, 1)),
        inertia=np.tile(m.inertia, (N, 1, 1, 1)),
        friction=rng.uniform(0.2, 2.0, N).astype(f32),
        box_q=box_q, box_qd=rng.normal(0, 0.1, (N, 6)).astype(f32),
        box_mass=np.full(N, 1.0, f32), box_i_diag=np.full((N, 3), 0.0017, f32))
    carry = {
        "terr": (np.abs(rng.normal(0, 5, (N, 84, 3)))
                 * np.asarray([0.2, 0.2, 1.0])).astype(f32),
        "boxg": np.zeros((N, 84, 3), f32),
        "corner": np.abs(rng.normal(0, 1, (N, 8, 3))).astype(f32)}
    return dict(jm=jm, m=m, jctx=jctx, ctx=ctx, jhf=jhf, hf=hf, feet=feet,
                box=box, default=default, inputs=inputs, carry=carry)


def test_fused_step_matches_jax(scene, monkeypatch):
    s, x = scene, scene["inputs"]
    default = s["default"]

    def jtau(c, qa, qda):
        return c, jnp.clip(KP * (jnp.asarray(default) - qa[:, 7:])
                           - KD * qda[:, 6:], -30.0, 30.0)

    def ttau(qa, qda):
        return torch.clamp(KP * (torch.as_tensor(default) - qa[:, 7:])
                           - KD * qda[:, 6:], -30.0, 30.0)

    monkeypatch.setenv("DWBC_UNROLL", "4")  # straight-line substeps
    jstep = jfused.make_fused_substep(s["jm"], jengine.SimParams(), s["jhf"],
                                      s["jctx"], s["feet"],
                                      box_half_extents=s["box"])
    with jax.disable_jit():
        jout, _, jbq, jbqd = jstep(
            jnp.asarray(x["q"]), jnp.asarray(x["qd"]), jtau,
            jnp.asarray(x["mass"]), jnp.asarray(x["com"]),
            jnp.asarray(x["inertia"]), jnp.asarray(x["friction"]), 4,
            box_q=jnp.asarray(x["box_q"]), box_qd=jnp.asarray(x["box_qd"]),
            box_mass=jnp.asarray(x["box_mass"]),
            box_i_diag=jnp.asarray(x["box_i_diag"]),
            contact_carry={k: jnp.asarray(v) for k, v in s["carry"].items()})

    step = fused.make_fused_substep(s["m"], engine.SimParams(), s["hf"],
                                    s["ctx"], s["feet"], device="cpu",
                                    box_half_extents=s["box"])
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    out, bq, bqd = step(
        t["q"], t["qd"], ttau, t["mass"], t["com"], t["inertia"],
        t["friction"], 4, box_q=t["box_q"], box_qd=t["box_qd"],
        box_mass=t["box_mass"], box_i_diag=t["box_i_diag"],
        contact_carry={k: torch.as_tensor(v) for k, v in s["carry"].items()})

    # the scene exercises terrain contact and box-corner contact
    assert (np.abs(np.asarray(jout.contact_carry["terr"])).sum(-1) > 0).mean() > 0.02
    assert (np.abs(np.asarray(jout.contact_carry["corner"])).sum(-1) > 0).any()
    for name, o, r in (("q", out.q, jout.q), ("qd", out.qd, jout.qd),
                       ("box_q", bq, jbq), ("box_qd", bqd, jbqd),
                       ("torques", out.torques, jout.torques)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4, err_msg=name)
    for k, v in jout.contact_carry.items():
        np.testing.assert_allclose(out.contact_carry[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out.foot_forces.numpy(),
                               np.asarray(jout.foot_forces), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(out.body_forces.numpy(),
                               np.asarray(jout.body_forces), rtol=1e-5,
                               atol=1e-4)


def test_fused_step_without_box_matches_jax(monkeypatch):
    """The no-box step every legged task runs (the JAX step then returns
    (out, tau_carry) and the port's the FusedOut alone): go1, 92 spheres
    on 13 bodies, on a curriculum grid terrain with stairs and slopes,
    with a torque law that carries state through the substeps. Same
    tolerances as the case with the box."""
    from dwbc_tpu.envs import legged_config as jlc

    cfg = jlc.go1_rough()
    jm = jurdf.load_urdf(cfg.asset.file, armature=cfg.asset.armature)
    m = urdf.load_urdf(cfg.asset.file, armature=cfg.asset.armature)
    assert (len(m.geom_body), m.nb) == (92, 13)
    default = np.asarray([dict(cfg.init_state.default_joint_angles)[n]
                          for n in m.dof_names], np.float32)
    q_ref = np.zeros(m.nq, np.float32)
    q_ref[6] = 1.0
    q_ref[2] = cfg.init_state.pos[2]
    q_ref[7:] = default
    jctx = jengine.build_ctx(jm, jnp.asarray(q_ref))
    ctx = engine.PhysCtx(*(torch.as_tensor(np.array(getattr(jctx, f)))
                           for f in engine.PhysCtx._fields))
    gcfg = dict(num_rows=2, num_cols=5, border_size=3.0, seed=2)
    jgrid = jterr.grid_terrain(jterr.GridTerrainCfg(**gcfg))
    grid = terr.grid_terrain(terr.GridTerrainCfg(**gcfg), device="cpu")
    feet = m.geoms_of("foot")

    rng = np.random.default_rng(1)
    f32 = np.float32
    # two envs per subterrain of the harder row, off the centre platform
    cols = np.arange(N) % 5
    q = np.tile(q_ref, (N, 1))
    q[:, 0] = 12.0 + rng.uniform(-3.0, 3.0, N)
    q[:, 1] = (cols + 0.5) * 8.0 + rng.uniform(-3.0, 3.0, N)
    ground = np.asarray(jgrid.hf.sample(jnp.asarray(q[:, 0]),
                                        jnp.asarray(q[:, 1])))
    q[:, 2] = ground + rng.uniform(0.22, 0.34, N)
    q[:, 7:] += rng.normal(0, 0.1, (N, m.nj))
    x = dict(q=q.astype(f32), qd=rng.normal(0, 0.3, (N, m.nv)).astype(f32),
             mass=np.tile(m.mass, (N, 1)), com=np.tile(m.com, (N, 1, 1)),
             inertia=np.tile(m.inertia, (N, 1, 1, 1)),
             friction=rng.uniform(0.2, 2.0, N).astype(f32))
    carry = {"terr": (np.abs(rng.normal(0, 5, (N, 92, 3)))
                      * np.asarray([0.2, 0.2, 1.0])).astype(f32)}
    bias0 = rng.normal(0, 1.0, (N, m.nj)).astype(f32)

    # a stateful law: the carry is a torque bias that halves each substep
    def jtau(c, qa, qda):
        return 0.5 * c, jnp.clip(KP * (jnp.asarray(default) - qa[:, 7:])
                                 - KD * qda[:, 6:] + c, -30.0, 30.0)

    def ttau(c, qa, qda):
        return 0.5 * c, torch.clamp(KP * (torch.as_tensor(default) - qa[:, 7:])
                                    - KD * qda[:, 6:] + c, -30.0, 30.0)

    monkeypatch.setenv("DWBC_UNROLL", "4")
    jstep = jfused.make_fused_substep(
        jm, jengine.SimParams(), jgrid.hf, jctx, feet)
    with jax.disable_jit():
        jout, jc = jstep(
            *(jnp.asarray(x[k]) for k in ("q", "qd")), jtau,
            *(jnp.asarray(x[k]) for k in ("mass", "com", "inertia",
                                          "friction")), 4,
            tau_carry=jnp.asarray(bias0),
            contact_carry={k: jnp.asarray(v) for k, v in carry.items()})

    step = fused.make_fused_substep(m, engine.SimParams(), grid.hf, ctx, feet,
                                    device="cpu")
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    out, c = step(t["q"], t["qd"], ttau, t["mass"], t["com"], t["inertia"],
                  t["friction"], 4, tau_carry=torch.as_tensor(bias0),
                  contact_carry={k: torch.as_tensor(v)
                                 for k, v in carry.items()})
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(c.numpy(), bias0 / 16)
    assert set(out.contact_carry) == {"terr"}
    assert (np.abs(np.asarray(jout.contact_carry["terr"])).sum(-1) > 0
            ).mean() > 0.02
    for name, o, r in (("q", out.q, jout.q), ("qd", out.qd, jout.qd),
                       ("torques", out.torques, jout.torques)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4, err_msg=name)
    for name, o, r in (("carry", out.contact_carry["terr"],
                        jout.contact_carry["terr"]),
                       ("foot_forces", out.foot_forces, jout.foot_forces),
                       ("body_forces", out.body_forces, jout.body_forces)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4, err_msg=name)

    # without tau_carry the law takes (q, qd) and the step returns the
    # FusedOut alone
    plain = step(t["q"], t["qd"], lambda qa, qda: ttau(0.0, qa, qda)[1],
                 t["mass"], t["com"], t["inertia"], t["friction"], 1)
    assert isinstance(plain, fused.FusedOut) and plain.q.shape == (N, m.nq)
