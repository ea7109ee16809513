"""LeggedRobotEnv of the port against the JAX package's, one step from a
carried state, for the three robot classes the family spans: go1 (grid
terrain with curriculum, 187 measured heights), anymal_c_rough (the LSTM
actuator net; its hidden state is compared) and cassie (two feet, the
`no_fly` reward, a `termination` reward added after the clamp).

The two frameworks draw different random numbers, so the step is held on
a state where no draw reaches what is compared: observation noise off, no
env at a command-resample or push tick, and everything that a reset
re-draws (q, qd, commands, observations of the envs that reset) left out.
What a reset fixes without a draw is compared on every env: which envs
reset (exact), rewards (computed before the reset, on all envs: a timed
out env, an env whose base touches the ground and a non-finite env are
among them), zeroed sums, clocks, terrain levels and origins.

The JAX step runs eagerly (jax.disable_jit, substeps unrolled): the same
functions as the compiled path without minutes of XLA compile. Tolerance:
atol = rtol = 1e-4 on obs, q, qd, rewards, sums and statistics (the fused
step's own parity tolerance, four substeps of float32 contact law), the
actuator net's hidden state at 1e-4, flags and integers exact.

The reset and the command sampling are held by what they must satisfy
(ranges, masks, which rows changed), not number for number.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwbc_tpu.envs import legged_config as jlc
from dwbc_tpu.envs import legged_robot as jlegged
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.envs import legged_config as lc
from dwbc_tpu_torch.envs import legged_robot as legged

N = 16
TOL = dict(rtol=1e-4, atol=1e-4)
ROBOTS = ("go1_rough", "anymal_c_rough", "cassie_rough")
# rows given a fate: time-out, base on the ground, non-finite state
TIMEOUT, CRASH, NAN = 3, 1, 11


def quiet(cfg):
    return dataclasses.replace(
        cfg, noise=dataclasses.replace(cfg.noise, add_noise=False))


def state_tree(s):
    """A JAX LeggedState as the numpy tree interop takes."""
    a = np.asarray
    tree = {f: getattr(s, f) for f in s.__dataclass_fields__ if f != "key"}
    tree["robot"] = dict(q=a(s.robot.q), qd=a(s.robot.qd))
    tree["inert"] = dict(mass=a(s.inert.mass), com=a(s.inert.com),
                         inertia=a(s.inert.inertia))
    return jax.tree_util.tree_map(a, tree)


def carried_state(jenv, seed):
    """A mid-episode JAX state made with numpy: robots standing in and
    near contact with random joint offsets and velocities, warm contact
    carry, random bookkeeping, clocks off every tick."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    m = jenv.model
    with jax.disable_jit():
        s = jenv.init_state(jax.random.PRNGKey(seed))
    q = np.array(s.robot.q)
    q[:, 2] -= rng.uniform(0.02, 0.10, N).astype(f32)
    q[:, 7:] += rng.normal(0, 0.08, (N, m.nj)).astype(f32)
    yaw = rng.uniform(-3.0, 3.0, N)
    q[:, 3:7] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2),
                          np.cos(yaw / 2)], -1).astype(f32)
    qd = rng.normal(0, 0.3, (N, m.nv)).astype(f32)
    qd[NAN, 8] = np.nan
    ng = len(m.geom_body)
    nf = jenv.num_feet
    ep_len = rng.integers(1, 400, N).astype(np.int32)
    ep_len[TIMEOUT] = jenv.max_episode_length
    cmd = np.array(s.commands)
    cmd[:, :2] = rng.uniform(-1, 1, (N, 2))
    cmd[:, 3] = rng.uniform(-3, 3, N)
    cmd[0, :2] = 0.0                      # a standing command
    levels = rng.integers(0, 9, N).astype(np.int32)
    origins = np.array(s.env_origins)
    if jenv.grid is not None:
        origins = jenv.grid.env_origins[levels, np.asarray(s.terrain_types)]
        q[:, :2] = origins[:, :2] + rng.uniform(-1, 1, (N, 2))
        q[:, 2] = origins[:, 2] + jenv.cfg.init_state.pos[2] - rng.uniform(
            0.02, 0.10, N)
        q[5, :2] = origins[5, :2] + [4.5, 0.0]    # walked off: moves up
    # a pose whose base still presses on the ground in the last substep
    # (the contact law pushes a resting penetration out before it): go1
    # belly down and falling, the others on their backs
    ground = float(jenv.hf.sample(jnp.asarray(q[CRASH, 0]),
                                  jnp.asarray(q[CRASH, 1])))
    if "go1" in jenv.cfg.asset.file:
        q[CRASH, 2] = ground + 0.05
        qd[CRASH, :6] = [0.0, 0.0, -1.0, 0.0, 0.0, 0.0]
    else:
        q[CRASH, 2] = ground + 0.03
        q[CRASH, 3:7] = [1.0, 0.0, 0.0, 0.0]
    kw = dict(
        robot=s.robot.replace(q=jnp.asarray(q, f32), qd=jnp.asarray(qd)),
        episode_length=jnp.asarray(ep_len),
        common_step=jnp.asarray(7, jnp.int32),
        last_actions=jnp.asarray(rng.normal(0, 0.3, (N, m.nj)), f32),
        last_dof_vel=jnp.asarray(rng.normal(0, 0.5, (N, m.nj)), f32),
        commands=jnp.asarray(cmd, f32),
        feet_air_time=jnp.asarray(rng.uniform(0, 0.6, (N, nf))
                                  * (rng.random((N, nf)) < 0.6), f32),
        last_contacts=jnp.asarray(rng.random((N, nf)) < 0.5),
        env_origins=jnp.asarray(origins, f32),
        terrain_levels=jnp.asarray(levels),
        contact_carry={"terr": jnp.asarray(
            np.abs(rng.normal(0, 3, (N, ng, 3))) * [0.2, 0.2, 1.0], f32)},
        episode_reward=jnp.asarray(rng.normal(0, 1, N), f32),
        episode_sums={k: jnp.asarray(rng.normal(0, 1, N), f32)
                      for k in s.episode_sums})
    if jenv.cfg.control.use_actuator_network:
        kw["actuator_hidden"] = jnp.asarray(
            rng.normal(0, 0.3, s.actuator_hidden.shape), f32)
    return s.replace(**kw)


@pytest.fixture(scope="module", params=ROBOTS)
def stepped(request):
    name = request.param
    jenv = jlegged.LeggedRobotEnv(quiet(getattr(jlc, name)()), num_envs=N,
                                  seed=1)
    env = legged.LeggedRobotEnv(quiet(getattr(lc, name)()), num_envs=N,
                                seed=1, device="cpu")
    jstate = carried_state(jenv, seed=ROBOTS.index(name))
    state = interop.legged_state_from_numpy(state_tree(jstate), device="cpu")
    actions = (0.5 * np.random.default_rng(9).normal(size=(N, 12))).astype(
        np.float32)
    import os
    old = os.environ.get("DWBC_UNROLL")
    os.environ["DWBC_UNROLL"] = "4"          # straight-line substeps
    try:
        with jax.disable_jit():
            jnew, jout = jenv.step(jstate, jnp.asarray(actions))
    finally:
        if old is None:
            del os.environ["DWBC_UNROLL"]
        else:
            os.environ["DWBC_UNROLL"] = old
    new, out = env.step(state, torch.as_tensor(actions))
    return name, jenv, env, jstate, jnew, jout, new, out


def close(got, want, msg, rows=None):
    got, want = got.detach().numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


def test_env_statics_match(stepped):
    name, jenv, env, *_ = stepped
    assert env.num_obs == jenv.num_obs and env.num_feet == jenv.num_feet
    assert env.reward_names == jenv.reward_names
    assert env.metric_names == jenv.metric_names
    assert env.reward_scales == jenv.reward_scales
    for a in ("default_dof_pos", "p_gains", "d_gains", "torque_limits",
              "noise_vec", "height_points"):
        assert np.array_equal(getattr(env, a).numpy(),
                              np.asarray(getattr(jenv, a))), a
    for a, b in zip(env.dof_pos_limits_soft, jenv.dof_pos_limits_soft):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(env.feet_geoms, np.asarray(jenv.feet_geoms))
    assert np.array_equal(env.penalized_bodies.numpy(), jenv.penalized_bodies)
    assert np.array_equal(env.termination_bodies.numpy(),
                          jenv.termination_bodies)
    assert (env.max_episode_length, env.resample_interval,
            env.push_interval) == (jenv.max_episode_length,
                                   jenv.resample_interval, jenv.push_interval)
    if name == "go1_rough":
        assert env.num_obs == 235 and len(env.model.geom_body) == 92
        assert np.array_equal(env._fam_of_col.numpy(),
                              np.asarray(jenv._fam_of_col))
    if name == "cassie_rough":
        assert env.num_feet == 4 and "no_fly" in env.reward_names  # 2 per toe
        assert "termination" in env.reward_names


def test_step_matches_jax(stepped):
    name, jenv, env, jstate, jnew, jout, new, out = stepped
    reset = np.asarray(jout.reset)
    assert np.array_equal(out.reset.numpy(), reset)
    assert np.array_equal(out.time_outs.numpy(), np.asarray(jout.time_outs))
    assert reset[[TIMEOUT, CRASH, NAN]].all() and reset.sum() < N // 2
    assert bool(jout.time_outs[TIMEOUT]) and not bool(jout.time_outs[CRASH])
    assert int(out.num_resets) == int(jout.num_resets) == reset.sum()
    live = ~reset

    close(out.rew, jout.rew, "rew")
    assert np.isfinite(out.rew.numpy()).all() and float(out.rew[NAN]) == 0.0
    close(out.obs, jout.obs, "obs", live)
    close(new.robot.q, jnew.robot.q, "q", live)
    close(new.robot.qd, jnew.robot.qd, "qd", live)
    close(new.commands, jnew.commands, "commands", live)
    close(new.torques, jnew.torques, "torques", live)
    close(new.foot_forces, jnew.foot_forces, "foot_forces", live)
    close(new.body_forces, jnew.body_forces, "body_forces", live)
    close(new.contact_carry["terr"], jnew.contact_carry["terr"], "carry")
    # the scene is in contact, and a reset zeroed its rows of the carry
    carry = new.contact_carry["terr"].numpy()
    assert (np.abs(carry[live]).sum(-1) > 0).mean() > 0.01
    assert not carry[reset].any()

    for f in ("last_actions", "last_dof_vel", "feet_air_time",
              "episode_reward", "env_origins", "actions"):
        rows = live if f == "last_dof_vel" else None
        close(getattr(new, f), getattr(jnew, f), f, rows)
    for f in ("last_contacts", "episode_length", "terrain_levels",
              "terrain_types", "reset_buf", "time_out_buf", "common_step"):
        assert np.array_equal(getattr(new, f).numpy(),
                              np.asarray(getattr(jnew, f))), f
    assert int(new.common_step) == 8
    assert set(new.episode_sums) == set(jnew.episode_sums)
    for k, v in jnew.episode_sums.items():
        close(new.episode_sums[k], v, "sum " + k)
        assert not new.episode_sums[k].numpy()[reset].any()

    assert set(out.episode_stats) == set(jout.episode_stats)
    assert "terrain_level" in out.episode_stats
    for k, v in jout.episode_stats.items():
        close(out.episode_stats[k], v, "stat " + k)

    if name == "go1_rough":
        # the walked-off env that reset would have moved up; a live one
        # keeps its level; the height scan is in the observation
        assert out.obs.shape == (N, 235)
        heights = out.obs.numpy()[live][:, 48:]
        assert np.ptp(heights) > 0.1
        assert any(k.startswith("metric_level_") for k in out.episode_stats)
    if name == "anymal_c_rough":
        h, jh = new.actuator_hidden.numpy(), np.asarray(jnew.actuator_hidden)
        assert h.shape == (2, 2, N * 12, 8)
        np.testing.assert_allclose(h, jh, **TOL)
        per_env = h.reshape(2, 2, N, 12, 8)
        assert not per_env[:, :, reset].any()
        assert np.abs(per_env[:, :, live]).min(axis=(0, 1, 3, 4)).max() >= 0
        assert (np.abs(per_env[:, :, live]).sum(axis=(0, 1, 3, 4)) > 0).all()
    if name == "cassie_rough":
        # the termination reward lands on the crashed env, after the clamp
        scale = env.reward_scales["termination"]
        assert scale < 0 and float(out.rew[CRASH]) < 0.5 * scale
        assert float(out.rew[TIMEOUT]) > 0.5 * scale


def test_reset_and_commands_hold_their_contract(stepped):
    """What the reset re-draws, by what it must satisfy."""
    name, jenv, env, jstate, jnew, jout, new, out = stepped
    cfg = env.cfg
    reset = out.reset.numpy()
    q = new.robot.q.numpy()[reset]
    origins = new.env_origins.numpy()[reset]
    # base over its (possibly new) origin, at the init height, upright
    spread = 1.0 if env.grid is not None else 0.0
    assert (np.abs(q[:, :2] - origins[:, :2]) <= spread + 1e-6).all()
    np.testing.assert_allclose(q[:, 2], origins[:, 2] + cfg.init_state.pos[2],
                               atol=1e-6)
    assert np.array_equal(q[:, 3:7], np.tile([0, 0, 0, 1.0], (len(q), 1)))
    lo = np.minimum(0.5 * env.default_dof_pos.numpy(),
                    1.5 * env.default_dof_pos.numpy())
    hi = np.maximum(0.5 * env.default_dof_pos.numpy(),
                    1.5 * env.default_dof_pos.numpy())
    lo = np.clip(lo, env.dof_lower.numpy(), env.dof_upper.numpy())
    hi = np.clip(hi, env.dof_lower.numpy(), env.dof_upper.numpy())
    assert ((q[:, 7:] >= lo - 1e-6) & (q[:, 7:] <= hi + 1e-6)).all()
    qd = new.robot.qd.numpy()[reset]
    assert (np.abs(qd[:, :6]) <= 0.5).all() and not qd[:, 6:].any()
    assert np.isfinite(new.robot.q.numpy()).all()
    assert np.isfinite(out.obs.numpy()).all()

    cmd = new.commands.numpy()[reset]
    c = cfg.commands
    assert ((cmd[:, 0] >= c.lin_vel_x[0]) & (cmd[:, 0] <= c.lin_vel_x[1])).all()
    assert ((cmd[:, 3] >= c.heading[0]) & (cmd[:, 3] <= c.heading[1])).all()
    norm = np.linalg.norm(cmd[:, :2], axis=1)
    assert ((norm == 0) | (norm > 0.2)).all()       # small commands zeroed
    assert not cmd[:, 2].any()   # yaw rate comes from the heading next step
    if env.grid is not None:
        # the walked-off env is alive, so its level is kept; a reset env
        # moves one level at most, down for the three that stood still
        before = np.asarray(jstate.terrain_levels)
        after = new.terrain_levels.numpy()
        assert np.array_equal(after[~reset], before[~reset])
        assert (np.abs(after[reset] - before[reset]) <= 1).all()


def test_sample_commands_and_init_state():
    env = legged.LeggedRobotEnv(lc.anymal_c_rough(), num_envs=512, seed=3,
                                device="cpu")
    gen = torch.Generator().manual_seed(5)
    state, obs = env.reset(gen)
    assert state.generator is gen and obs.shape == (512, 235)
    dr = env.cfg.domain_rand
    assert len(torch.unique(state.friction)) <= dr.friction_buckets
    assert float(state.friction.min()) >= dr.friction_range[0]
    assert float(state.friction.max()) <= dr.friction_range[1]
    # base mass randomisation lands on body 0 alone
    base = env.model.mass
    added = state.inert.mass.numpy() - base[None]
    assert np.abs(added[:, 0]).max() > 1.0 and not added[:, 1:].any()
    np.testing.assert_allclose(added[:, 0], state.added_mass.numpy(),
                               atol=1e-5)
    assert (np.abs(state.added_mass.numpy()) <= 5.0).all()
    # the initial reset skips the curriculum: levels stay in the init range
    assert int(state.terrain_levels.max()) <= 5
    assert torch.equal(state.terrain_types,
                       torch.arange(512) * 20 // 512)
    want = env.terrain_origins[state.terrain_levels, state.terrain_types]
    assert torch.equal(state.env_origins, want)
    assert not state.actuator_hidden.any()
    assert state.common_step.dim() == 0 and state.command_lin_vel_x.shape == (2,)

    cmd = env._sample_commands(gen, state)
    norm = torch.linalg.norm(cmd[:, :2], dim=1)
    assert bool(((norm == 0) | (norm > 0.2)).all())
    assert 0 < int((norm == 0).sum()) < 200
    assert not cmd[:, 2].any() and bool((cmd[:, 3].abs() <= 3.14).all())
