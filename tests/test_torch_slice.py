"""The slice end to end: one widowGo1 env.step of the port against the JAX
package from one carried state, and a Rollout.collect of the port.

The JAX env is built as the behaviour tests build it (plane, N=8, seed=1,
default config, pushes on) and stepped eagerly (jax.disable_jit). The two
packages draw different random numbers, so the compared step is one in
which no draw reaches the output: no push lands, no env resets, no
command is resampled and no EE goal expires (each checked). The base is
lowered so the feet strike the ground during the step. Tolerance: atol 1e-4 / rtol
1e-4 on obs and the post-step state (the fused step's atol 1e-4 carried
through FK and the observation maps) and 1e-6 on the rewards, which are
divided by 100.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.envs.config import TerrainCfg as JTerrainCfg
from dwbc_tpu.envs.config import WidowGo1Cfg as JWidowGo1Cfg
from dwbc_tpu.envs.widowgo1 import WidowGo1Env as JWidowGo1Env
from dwbc_tpu_torch.envs.config import TerrainCfg, WidowGo1Cfg
from dwbc_tpu_torch.envs.widowgo1 import WidowGo1Env
from dwbc_tpu_torch.interop import env_state_from_numpy
from dwbc_tpu_torch.models.actor_critic import ActorCritic
from dwbc_tpu_torch.rl.runner import Rollout, init_at_random_ep_len
from dwbc_tpu_torch.utils import device as device_lib
from dwbc_tpu_torch.utils import spans, task_registry

N = 8
COUNTER = 3.0


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


@pytest.fixture(scope="module")
def carried():
    jenv = JWidowGo1Env(dataclasses.replace(
        JWidowGo1Cfg(), terrain=JTerrainCfg(mesh_type="plane")),
        num_envs=N, seed=1)
    env = WidowGo1Env(dataclasses.replace(
        WidowGo1Cfg(), terrain=TerrainCfg(mesh_type="plane")),
        num_envs=N, seed=1, device="cpu")
    with jax.disable_jit():
        jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    q = np.array(jstate.robot.q)
    q[:, 2] = 0.33  # feet in ground contact during the step's substeps
    jstate = jstate.replace(robot=jstate.robot.replace(q=jnp.asarray(q)))
    actions = (0.3 * np.random.default_rng(0).normal(size=(N, 18))
               ).astype(np.float32)
    with jax.disable_jit():
        jstate2, jout = jenv.step(jstate, jnp.asarray(actions),
                                  jnp.asarray(COUNTER))
    return jenv, env, jstate, jstate2, jout, actions


def test_env_step_matches_jax(carried):
    jenv, env, jstate, jstate2, jout, actions = carried
    # the chosen step draws nothing that reaches the output
    assert (int(jstate.common_step) + 1) % jenv.push_interval != 0
    assert np.all((np.asarray(jstate.episode_length) + 1)
                  % jenv.resample_interval != 0)
    assert np.all(np.asarray(jstate.goal_timer) + 1
                  <= np.asarray(jstate.traj_total_timesteps))
    assert not np.asarray(jout.reset).any()

    state = env_state_from_numpy(tree_np(jstate), device="cpu")
    state2, out = env.step(state, torch.as_tensor(actions), COUNTER)

    assert (np.asarray(jout.obs[:, 12:32]) != 0).any()
    # foot spheres start below the plane: the step runs the contact law
    R, p, *_ = env.fused_step.fk(state.robot.q)
    m = env.model
    foot_z = torch.stack([(p[b] + R[b] @ torch.as_tensor(m.geom_pos[g]))[:, 2]
                          for g, b in zip(env.feet_geoms, env.feet_bodies)])
    assert (foot_z < torch.as_tensor(m.geom_radius[env.feet_geoms])[:, None]
            ).any()
    np.testing.assert_allclose(out.obs.numpy(), np.asarray(jout.obs),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.rew.numpy(), np.asarray(jout.rew),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.arm_rew.numpy(), np.asarray(jout.arm_rew),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out.reset.numpy(), np.asarray(jout.reset))
    for name in ("q", "qd"):
        np.testing.assert_allclose(
            getattr(state2.robot, name).numpy(),
            np.asarray(getattr(jstate2.robot, name)), rtol=1e-4, atol=1e-4,
            err_msg=name)
    np.testing.assert_allclose(state2.foot_forces.numpy(),
                               np.asarray(jstate2.foot_forces), rtol=1e-4,
                               atol=1e-3)


def test_rollout_collect_on_port():
    env, spec = task_registry.make_env("widowGo1", num_envs=4, seed=1,
                                       device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    state = init_at_random_ep_len(state, env.max_episode_length, gen)
    torch.manual_seed(0)
    rollout = Rollout(env, ActorCritic(), spec.ppo_cfg, num_steps=3)
    launches = spans.total("contact_kernel")
    for hist in (True, False):
        state, obs, traj, stats, nres = rollout.collect(
            state, obs, 1.0, torch.Generator().manual_seed(1), hist)
        assert traj.obs.shape == (3, 4, 860)
        assert traj.actions.shape == (3, 4, 18)
        assert traj.rewards.shape == (3, 4, 2)
        assert traj.values.shape == (3, 4, 2)
        assert traj.log_probs.shape == (3, 4, 2)
        for name, t in traj._asdict().items():
            assert torch.isfinite(t.float()).all(), name
        assert torch.isfinite(state.robot.q).all()
        assert set(stats) == set(rollout.stat_keys())
    # the CPU runs the plain law
    assert spans.total("contact_kernel") == launches


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device_lib.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        task_registry.make_env("widowGo1", num_envs=2)
