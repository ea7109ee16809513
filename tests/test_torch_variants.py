"""The widowGo1 variants of the port against the JAX package: the batched
rigid-body functions behind the OSC expert, the adaptive arm gains, the
OSC torque-supervision target, droop compensation and the extras that the
rollout carries into the trajectory.

Inputs come from numpy seeds; the JAX side runs eagerly (jax.disable_jit).
Tolerances: rnea_bias, body_jacobian, solve_spd and orientation_error
rtol 1e-5 (atol 1e-5, float32 sums over 21 bodies); `_pd_torques` and
`_osc_target` at N = 8 from one carried state rtol 1e-4 / atol 1e-4; the
droop values 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.core import maths as jmaths
from dwbc_tpu.core import urdf as jurdf
from dwbc_tpu.sim import dynamics as jdyn
from dwbc_tpu.utils import task_registry as jregistry
from dwbc_tpu_torch.core import maths, urdf
from dwbc_tpu_torch.interop import env_state_from_numpy
from dwbc_tpu_torch.models.actor_critic import ActorCritic
from dwbc_tpu_torch.rl.runner import Rollout
from dwbc_tpu_torch.sim import dynamics
from dwbc_tpu_torch.utils import task_registry

N = 8
TOL5 = dict(rtol=1e-5, atol=1e-5)
TOL4 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: beside other test workers on the same
    machine, one thread per core only oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_np(x):
    """Nested dict of numpy arrays from the JAX env's state pytree."""
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    if hasattr(x, "_asdict"):
        return {k: tree_np(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def random_q_qd(n, nq, nv, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, nq), np.float32)
    q[:, :3] = rng.normal(size=(n, 3))
    quat = rng.normal(size=(n, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = 0.5 * rng.normal(size=(n, nq - 7))
    return q, rng.normal(size=(n, nv)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = jurdf.load_urdf(jurdf.WIDOW_GO1_URDF,
                         dof_order=jurdf.WIDOW_GO1_DOF_ORDER, armature=0.01)
    m = urdf.load_urdf(urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
                       armature=0.01)
    return jm, m


def test_rnea_bias_matches(models):
    jm, m = models
    q, qd = random_q_qd(3, m.nq, m.nv, seed=0)
    jin = jdyn.default_inertial(jm)
    with jax.disable_jit():
        want = np.stack([np.asarray(jdyn.rnea_bias(
            jm, jin, jnp.asarray(q[i]), jnp.asarray(qd[i])))
            for i in range(3)])
    inert = dynamics.default_inertial(m, "cpu")
    got = dynamics.rnea_bias(m, inert, torch.as_tensor(q),
                             torch.as_tensor(qd))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    # one env without a batch dimension, and per-env inertial parameters
    one = dynamics.rnea_bias(m, inert, torch.as_tensor(q[1]),
                             torch.as_tensor(qd[1]))
    np.testing.assert_allclose(one.numpy(), want[1], rtol=1e-5, atol=2e-5)
    batched = dynamics.Inertial(*(x[None].repeat((3,) + (1,) * x.dim())
                                  for x in inert))
    got = dynamics.rnea_bias(m, batched, torch.as_tensor(q),
                             torch.as_tensor(qd))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_body_jacobian_matches(models):
    jm, m = models
    q, _ = random_q_qd(3, m.nq, m.nv, seed=1)
    body = m.sites["wx250s/ee_gripper_link"].body
    off = np.asarray(m.sites["wx250s/ee_gripper_link"].pos, np.float32)
    with jax.disable_jit():
        want = np.stack([np.asarray(jdyn.body_jacobian(
            jm, jnp.asarray(q[i]), body, jnp.asarray(off))) for i in range(3)])
        want_calf = np.asarray(jdyn.body_jacobian(jm, jnp.asarray(q[0]), 3))
    got = dynamics.body_jacobian(m, torch.as_tensor(q), body,
                                 torch.as_tensor(off))
    assert got.shape == (3, 6, m.nv)
    np.testing.assert_allclose(got.numpy(), want, **TOL5)
    np.testing.assert_allclose(
        dynamics.body_jacobian(m, torch.as_tensor(q[0]), 3).numpy(),
        want_calf, **TOL5)


def test_solve_spd_and_orientation_error_match():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 6, 6))
    A = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    b_vec = rng.normal(size=(5, 6)).astype(np.float32)
    b_mat = rng.normal(size=(5, 6, 4)).astype(np.float32)
    for b in (b_vec, b_mat):
        want = np.stack([np.asarray(jmaths.solve_spd(jnp.asarray(A[i]),
                                                     jnp.asarray(b[i])))
                         for i in range(5)])
        got = maths.solve_spd(torch.as_tensor(A), torch.as_tensor(b))
        np.testing.assert_allclose(got.numpy(), want, **TOL5)
        np.testing.assert_allclose(
            np.einsum("nij,nj...->ni...", A, got.numpy()), b, rtol=1e-3,
            atol=1e-3)
    q1 = rng.normal(size=(7, 4)).astype(np.float32)
    q2 = rng.normal(size=(7, 4)).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        maths.orientation_error(torch.as_tensor(q1), torch.as_tensor(q2)).numpy(),
        np.asarray(jmaths.orientation_error(jnp.asarray(q1), jnp.asarray(q2))),
        **TOL5)
    np.testing.assert_allclose(
        maths.yaw_quat(torch.as_tensor(q1)).numpy(),
        np.asarray(jmaths.yaw_quat(jnp.asarray(q1))), **TOL5)


def test_solve_spd_singular_and_nan_match():
    """A batch of SPD, exactly rank-deficient (a zero pivot, floored to
    1e-12 in both packages) and NaN matrices, b as a vector and as k = 4
    columns: no raise, the SPD and zero-pivot solutions equal to the JAX
    package's at rtol 1e-5, NaN in both for the NaN matrix."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(4, 6, 6))
    A = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    A[1] = np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    A[3, 4, 2] = np.nan          # below the diagonal: the factor reads it
    for b in (rng.normal(size=(4, 6)), rng.normal(size=(4, 6, 4))):
        b = b.astype(np.float32)
        want = np.stack([np.asarray(jmaths.solve_spd(jnp.asarray(A[i]),
                                                     jnp.asarray(b[i])))
                         for i in range(4)])
        got = maths.solve_spd(torch.as_tensor(A), torch.as_tensor(b)).numpy()
        assert np.isnan(want[3]).all() and np.isnan(got[3]).all()
        assert np.isfinite(want[:3]).all() and np.abs(want[1]).max() > 1e11
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)


@pytest.fixture(scope="module")
def adaptive_envs():
    """The adaptive variant on a plane in both packages, and one JAX state
    made lively (random joint angles, velocities, base attitude and EE
    goal) and carried into the port."""
    jenv = jregistry._widow_env(N, 1, terrain="plane", adaptive=True)
    env = task_registry._widow_env(N, 1, "cpu", terrain="plane", adaptive=True)
    with jax.disable_jit():
        jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    q = np.array(jstate.robot.q)
    quat = q[:, 3:7] + 0.2 * rng.normal(size=(N, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] += 0.2 * rng.normal(size=(N, q.shape[1] - 7))
    # the arm bent well away from its straight default pose: there the
    # task-space matrix J M^-1 J^T is near singular (condition number
    # 1e4..1e6) and two float32 solves of it agree to 1e-3 at best
    q[:, 19:25] = (np.array([0.3, -0.6, 0.8, 0.4, 0.7, 0.3])
                   + 0.1 * rng.normal(size=(N, 6)))
    qd = 0.5 * rng.normal(size=np.shape(jstate.robot.qd))
    goal = np.array([0.5, 0.0, 0.4]) + 0.2 * rng.normal(size=(N, 3))
    jstate = jstate.replace(
        robot=jstate.robot.replace(q=jnp.asarray(q, jnp.float32),
                                   qd=jnp.asarray(qd, jnp.float32)),
        curr_ee_goal_cart=jnp.asarray(goal, jnp.float32))
    state = env_state_from_numpy(tree_np(jstate), device="cpu")
    return jenv, env, jstate, state


def test_variants_build_and_widen(adaptive_envs):
    _, env, _, state = adaptive_envs
    assert env.num_actions == 24 and env.num_proprio == 82
    assert env.num_obs == 82 * 11 + 24
    assert state.actions.shape == (N, 24)
    flat, spec = task_registry.make_env("widowGo1_flat", 2, device="cpu")
    assert flat.cfg.termination.z_threshold == 0.25
    assert spec.experiment_name == "flat_widowGo1"
    spec = task_registry.TASKS["widowGo1_adaptive"]
    assert spec.ppo_cfg.torque_supervision and spec.ppo_cfg.adaptive_arm_gains
    assert len(spec.ppo_cfg.min_policy_std) == 24


def test_pd_torques_adaptive_matches(adaptive_envs):
    jenv, env, jstate, state = adaptive_envs
    rng = np.random.default_rng(4)
    actions = rng.normal(size=(N, 24)).astype(np.float32)
    actions[:, 18:] *= 6.0       # some kp deltas below -5: the 0 floor acts
    assert (actions[:, 18:] < -5.0).any()
    want = jenv._pd_torques(jnp.asarray(actions), jstate.robot.q[:, 7:25],
                            jstate.robot.qd[:, 6:24], jstate.motor_strength)
    got = env._pd_torques(torch.as_tensor(actions), state.robot.q[:, 7:25],
                          state.robot.qd[:, 6:24], state.motor_strength)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)


def test_osc_target_matches(adaptive_envs):
    jenv, env, jstate, state = adaptive_envs
    with jax.disable_jit():
        want = np.asarray(jenv._osc_target(jstate))
    got = env._osc_target(state)
    assert got.shape == (N, 6)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **TOL4)


@pytest.fixture(scope="module")
def poisoned(adaptive_envs):
    """The lively state with env 2's robot.qd set to NaN, in both
    packages."""
    jenv, env, jstate, state = adaptive_envs
    qd = np.array(jstate.robot.qd)
    qd[2] = np.nan
    jstate = jstate.replace(robot=jstate.robot.replace(qd=jnp.asarray(qd)))
    return jenv, env, jstate, env_state_from_numpy(tree_np(jstate),
                                                   device="cpu")


def test_osc_target_with_a_nan_env_matches(poisoned):
    """`_osc_target` from a state in which one env's velocities are NaN:
    no raise, the other envs equal to the JAX package's (eager) at the
    tolerance of test_osc_target_matches, the poisoned row non-finite in
    both."""
    jenv, env, jstate, state = poisoned
    with jax.disable_jit():
        want = np.asarray(jenv._osc_target(jstate))
    got = env._osc_target(state).numpy()
    assert not np.isfinite(want[2]).any() and not np.isfinite(got[2]).any()
    rest = np.arange(N) != 2
    assert np.isfinite(want[rest]).all()
    np.testing.assert_allclose(got[rest], want[rest], **TOL4)


def test_env_step_from_a_nan_env_resets_it(poisoned):
    """One widowGo1_adaptive env step of the port from that state runs to
    its end (the OSC solves, the terrain lookups and the contact law all
    see the NaN), marks the poisoned env `bad` and resets it, and leaves
    a finite state and observation."""
    _, env, _, state = poisoned
    actions = torch.as_tensor(
        0.3 * np.random.default_rng(7).normal(size=(N, 24)), dtype=torch.float32)
    state2, out = env.step(state, actions, 3.0)
    assert bool(out.reset[2]) and int(out.episode_stats["term_bad"]) >= 1
    assert int(out.num_resets) >= 1
    for name, t in (("q", state2.robot.q), ("qd", state2.robot.qd),
                    ("obs", out.obs), ("rew", out.rew),
                    ("arm_rew", out.arm_rew)):
        assert bool(torch.isfinite(t).all()), name
    assert not bool(torch.isfinite(out.extras["target_arm_torques"][2]).any())


def test_droop_compensation_matches(adaptive_envs):
    jenv, env, _, _ = adaptive_envs
    assert not env.droop_comp.any()
    try:
        jenv.enable_droop_compensation()
        env.enable_droop_compensation()
        want = np.asarray(jenv.droop_comp)
        assert np.abs(want[:12]).max() > 0.01 and not want[12:].any()
        np.testing.assert_allclose(env.droop_comp.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    finally:
        jenv.droop_comp = jnp.zeros(18)
        env.droop_comp = torch.zeros(18)


def test_spawn_relative_and_terminal_reward_scales():
    env, _ = task_registry.make_env("widowGo1", 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(gen)
    assert torch.all(state.robot.q[:, 2] == env.cfg.init_state.pos[2])
    env.spawn_relative = True       # no trace to guard: takes effect now
    state, _ = env.reset(gen)
    ground = env.hf.sample(state.robot.q[:, 0], state.robot.q[:, 1])
    torch.testing.assert_close(state.robot.q[:, 2], ground + 0.40)
    early = env.curriculum(0.5)     # the scale ramps end at counter 1
    env.terminal_reward_scales = True
    pinned = env.curriculum(0.5)
    g = env.cfg.goal_ee
    assert float(early["tracking_ee"]) < float(pinned["tracking_ee"])
    assert float(pinned["tracking_ee"]) == pytest.approx(
        g.final_tracking_ee_reward)
    np.testing.assert_array_equal(early["goal_ee_l"], pinned["goal_ee_l"])


def test_collect_carries_the_osc_extras():
    env, spec = task_registry.make_env("widowGo1_adaptive", 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    torch.manual_seed(0)
    model = ActorCritic(num_prop=env.num_proprio, adaptive_arm_gains=True,
                        init_std=(1.0,) * 24)
    rollout = Rollout(env, model, spec.ppo_cfg, num_steps=3)
    q_arm0 = state.robot.q[:, 19:25].clone()
    state, obs, traj, _, _ = rollout.collect(
        state, obs, 1.0, torch.Generator().manual_seed(1), False)
    assert traj.actions.shape == (3, 4, 24)
    assert traj.target_arm_torques.shape == (3, 4, 6)
    assert torch.isfinite(traj.target_arm_torques).all()
    assert traj.target_arm_torques.abs().max() > 0
    # the extras are the pre-physics arm state of each step
    torch.testing.assert_close(traj.current_arm_dof_pos[0], q_arm0)
    assert traj.current_arm_dof_vel[1:].abs().max() > 0
    # the default task sends no extras: zeros
    env, spec = task_registry.make_env("widowGo1", 2, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    _, _, traj, _, _ = Rollout(env, ActorCritic(), spec.ppo_cfg, 2).collect(
        state, obs, 1.0, torch.Generator().manual_seed(1), False)
    assert not traj.target_arm_torques.any()
