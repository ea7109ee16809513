"""The recurrent policy and its BPTT update, port against the JAX package,
and port twins of tests/test_recurrent.py (the sharded test has no
counterpart: the port runs on one device).

Model: flax weights carried in with interop.recurrent_from_flax, LSTM and
GRU; one step, a step with a done reset and a 6-step unroll agree to 1e-5
(carry included). Update: from the same weights, trajectory, initial
carry and env permutation (JAX's, fed through `perm=`), every parameter
rtol 1e-4 / atol 1e-5, the metrics rtol 1e-5 / atol 1e-6, the learning
rate exact. The JAX update is jitted (seconds at T = 6, N = 6).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwbc_tpu.models import actor_critic_recurrent as jrec
from dwbc_tpu.rl import ppo as jppo
from dwbc_tpu.rl import recurrent as jrl
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.envs import legged_config as lc
from dwbc_tpu_torch.envs.legged_robot import LeggedRobotEnv
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.rl import ppo, recurrent

KW = dict(num_obs=48, num_actions=12, rnn_hidden_size=16,
          actor_hidden_dims=(16,), critic_hidden_dims=(8,))
PPO_KW = dict(num_heads=1, use_dagger=False, use_roa=False,
              num_learning_epochs=2, num_mini_batches=2, entropy_coef=0.01,
              learning_rate=5e-4, schedule="adaptive", desired_kl=0.01,
              min_policy_std=(0.0,) * 12)


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def t_tree(x):
    """A (nested tuple) numpy carry as torch tensors."""
    if isinstance(x, tuple):
        return tuple(t_tree(c) for c in x)
    return torch.as_tensor(np.array(x))


def assert_tree_close(got, want, atol):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w, atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=atol)


def make_models(rnn_type, seed=0):
    jmodel = jrec.ActorCriticRecurrent(rnn_type=rnn_type, **KW)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((3, 48)))
    model = ActorCriticRecurrent(rnn_type=rnn_type, **KW)
    interop.recurrent_from_flax(np_tree(params), model)
    return jmodel, params, model


def random_carry(rnn_type, n, seed):
    rng = np.random.default_rng(seed)
    h = lambda: (0.5 * rng.normal(size=(n, 16))).astype(np.float32)
    if rnn_type == "lstm":
        return ((h(), h()), (h(), h()))
    return (h(), h())


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_step_and_unroll_match_flax(rnn_type):
    jmodel, params, model = make_models(rnn_type, seed=1)
    # every flax leaf found a home: same parameter count
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(2)
    B, Tn = 5, 6
    carry = random_carry(rnn_type, B, 3)
    obs = rng.normal(size=(Tn, B, 48)).astype(np.float32)
    dones = rng.random((Tn, B)) < 0.3
    dones[0, 1] = True
    jcarry = jax.tree_util.tree_map(jnp.asarray, carry)

    # one step without and with a done reset
    for d in (None, dones[0]):
        jc, jm, jv = jmodel.apply(params, jcarry, jnp.asarray(obs[0]),
                                  None if d is None else jnp.asarray(d),
                                  method="step")
        c, m, v = model.step(t_tree(carry), torch.as_tensor(obs[0]),
                             None if d is None else torch.as_tensor(d))
        assert m.shape == (B, 12) and v.shape == (B, 1)
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv),
                                   rtol=0, atol=1e-5)
        assert_tree_close(c, jc, 1e-5)

    jc, (jmeans, jvalues) = jmodel.apply(
        params, jcarry, jnp.asarray(obs), jnp.asarray(dones), method="unroll")
    c, (means, values) = model.unroll(t_tree(carry), torch.as_tensor(obs),
                                      torch.as_tensor(dones))
    assert means.shape == (Tn, B, 12) and values.shape == (Tn, B, 1)
    np.testing.assert_allclose(means.detach().numpy(), np.asarray(jmeans),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(values.detach().numpy(), np.asarray(jvalues),
                               rtol=0, atol=1e-5)
    assert_tree_close(c, jc, 1e-5)

    # initial_state has the flax carry's structure, and forward() is a
    # step from it
    zero = model.initial_state(B)
    assert_tree_close(zero, jmodel.initial_state_static(B), 0.0)
    jmean0, jstd, jval0 = jmodel.apply(params, jnp.asarray(obs[0]))
    mean0, std, val0 = model(torch.as_tensor(obs[0]))
    np.testing.assert_allclose(mean0.detach().numpy(), np.asarray(jmean0),
                               rtol=0, atol=1e-5)
    assert np.array_equal(std.detach().numpy(), np.asarray(jstd))


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_update_matches_jax(rnn_type):
    Tn, N = 6, 7      # 2 minibatches of 3 envs: one env is never used
    jmodel, params, model = make_models(rnn_type, seed=4)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    f32 = np.float32
    h0 = random_carry(rnn_type, N, 6)
    obs = rng.normal(size=(Tn, N, 48)).astype(f32)
    dones = rng.random((Tn, N)) < 0.25
    dones_prev = np.concatenate([rng.random((1, N)) < 0.3, dones[:-1]], 0)
    _, (mean, _) = jmodel.apply(
        params, jax.tree_util.tree_map(jnp.asarray, h0), jnp.asarray(obs),
        jnp.asarray(dones_prev), method="unroll")
    mean = np.asarray(mean)
    std = np.asarray(params["params"]["std"])
    actions = (mean + 0.3 * std * rng.normal(size=mean.shape)).astype(f32)
    logp = np.asarray(jrl._logp(jnp.asarray(actions), jnp.asarray(mean),
                                jnp.asarray(std)))
    traj_np = dict(
        obs=obs, actions=actions,
        rewards=rng.normal(size=(Tn, N, 1)).astype(f32), dones=dones,
        dones_prev=dones_prev,
        time_outs=dones & (rng.random((Tn, N)) < 0.5),
        values=rng.normal(size=(Tn, N, 1)).astype(f32), log_probs=logp,
        mu=(mean + 0.2 * rng.normal(size=mean.shape)).astype(f32),
        sigma=np.broadcast_to(std, mean.shape).copy())
    last = rng.normal(size=(N, 1)).astype(f32)
    key = jax.random.PRNGKey(31)

    jcfg = jppo.PPOConfig(**PPO_KW)
    jalg = jrl.RecurrentPPO(None, jmodel, jcfg, num_steps=Tn)
    import optax
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.scale_by_adam())
    jstate = jppo.PPOState(
        params=params, opt_state=tx.init(params),
        hist_opt_state=tx.init(params),
        learning_rate=jnp.asarray(jcfg.learning_rate),
        counter=jnp.zeros((), jnp.int32))
    jtraj = jrl.RecurrentTransition(**{k: jnp.asarray(v)
                                       for k, v in traj_np.items()})
    jstate2, jmetrics = jalg.update(
        jstate, jtraj, jax.tree_util.tree_map(jnp.asarray, h0),
        jnp.asarray(last), key)

    cfg = ppo.PPOConfig(**PPO_KW)
    alg = recurrent.RecurrentPPO(None, model, cfg, num_steps=Tn)
    state = ppo.PPOState(cfg, model)
    assert state.hist_opt is None
    traj = recurrent.RecurrentTransition(**{k: torch.as_tensor(v)
                                            for k, v in traj_np.items()})
    perm = torch.as_tensor(np.array(jax.random.permutation(key, N)))
    metrics = alg.update(state, traj, t_tree(h0), torch.as_tensor(last),
                         perm=perm)

    for p, want in interop._recurrent_leaves(np_tree(jstate2.params), model):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)
    assert set(metrics) == set(jmetrics) == {"value_loss", "surrogate_loss"}
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert state.learning_rate == float(jstate2.learning_rate)
    assert state.learning_rate != pytest.approx(5e-4)
    assert state.counter == int(jstate2.counter) == 1
    for k, v in model.state_dict().items():
        assert not torch.equal(v, start[k]), k


# ---------------------------------------------------------------------------
# twins of tests/test_recurrent.py


def _make():
    torch.manual_seed(0)
    return ActorCriticRecurrent(num_obs=48, num_actions=12,
                                rnn_hidden_size=64, actor_hidden_dims=(64,),
                                critic_hidden_dims=(64,))


@torch.no_grad()
def test_step_shapes_and_state_propagation():
    model = _make()
    carry = model.initial_state(3)
    obs = torch.ones((3, 48))
    carry1, mean1, val1 = model.step(carry, obs)
    assert mean1.shape == (3, 12) and val1.shape == (3, 1)
    # hidden state must change the output on repeated identical inputs
    _, mean2, _ = model.step(carry1, obs)
    assert not np.allclose(mean1.numpy(), mean2.numpy())


@torch.no_grad()
def test_done_resets_hidden_state():
    model = _make()
    obs = torch.ones((2, 48))
    carry, _, _ = model.step(model.initial_state(2), obs)
    carry, _, _ = model.step(carry, obs)
    # env 0 done -> its next output equals a fresh-state output
    _, mean_reset, _ = model.step(carry, obs, torch.tensor([True, False]))
    _, mean_fresh, _ = model.step(model.initial_state(2), obs)
    np.testing.assert_allclose(mean_reset[0].numpy(), mean_fresh[0].numpy(),
                               atol=1e-6)
    assert not np.allclose(mean_reset[1].numpy(), mean_fresh[1].numpy())


@torch.no_grad()
def test_unroll_matches_stepwise():
    model = _make()
    Tn, B = 5, 2
    obs_seq = torch.as_tensor(np.random.default_rng(1).normal(
        size=(Tn, B, 48)).astype(np.float32))
    dones = torch.zeros((Tn, B), dtype=torch.bool)
    dones[2, 0] = True
    _, (means, values) = model.unroll(model.initial_state(B), obs_seq, dones)
    assert means.shape == (Tn, B, 12) and values.shape == (Tn, B, 1)
    c = model.initial_state(B)
    for t in range(Tn):
        c, m, _ = model.step(c, obs_seq[t], dones[t])
        np.testing.assert_allclose(m.numpy(), means[t].numpy(), atol=1e-6)


def test_recurrent_training_improves_reward(tmp_path):
    """End-to-end BPTT training on go1_flat through RecurrentRunner, at the
    JAX twin's size (16 envs, 24 steps) but 30 iterations instead of 80:
    the eager env step costs 40 ms here, and 80 iterations would take two
    minutes. What 30 iterations show: every reward and weight finite,
    every weight moved, and the mean step reward of the last ten
    iterations not below that of the first ten."""
    env = LeggedRobotEnv(lc.go1_flat(), num_envs=16, seed=2, device="cpu")
    cfg = ppo.PPOConfig(**dict(PPO_KW, num_learning_epochs=3))
    log_dir = str(tmp_path / "run")
    runner = recurrent.RecurrentRunner(env, cfg, num_steps_per_env=24, seed=1,
                                       log_dir=log_dir)
    start = {k: v.clone() for k, v in runner.model.state_dict().items()}
    # 70,000 tiny ops: one thread is as fast as eight, and does not fight
    # the other test workers for the cores (ten times slower when it did)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hist = runner.learn(ITERATIONS, log=None, log_every=10)
    finally:
        torch.set_num_threads(threads)
    runner.close()
    assert len(hist) == ITERATIONS and np.isfinite(hist).all()
    early = float(np.mean(hist[:10]))
    late = float(np.mean(hist[-10:]))
    assert late >= early, (early, late)
    for k, v in runner.model.state_dict().items():
        assert torch.isfinite(v).all() and not torch.equal(v, start[k]), k
    assert runner.ppo_state.counter == ITERATIONS

    import json
    import os
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["it"] for r in rows] == list(range(0, ITERATIONS, 10))
    assert set(rows[0]) == {
        "it", "Train/mean_step_reward", "Train/mean_reward",
        "Train/mean_episode_length", "Train/dones", "Loss/value_loss",
        "Loss/surrogate_loss"}

    # checkpoint round trip into a second runner; the stateful inference
    # policy keeps its carry between calls
    other = recurrent.RecurrentRunner(
        LeggedRobotEnv(lc.go1_flat(), num_envs=4, seed=3, device="cpu"), cfg,
        seed=9)
    other.load(os.path.join(log_dir, f"model_{ITERATIONS}"))
    for a, b in zip(runner.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert other.ppo_state.counter == ITERATIONS
    assert other.ppo_state.learning_rate == runner.ppo_state.learning_rate
    policy = other.get_inference_policy()
    obs = torch.ones((4, 48))
    a1, a2 = policy(obs), policy(obs)
    assert a1.shape == (4, 12) and not torch.equal(a1, a2)
    other.force_terminal_schedules()     # accepted, nothing to force


ITERATIONS = 30
