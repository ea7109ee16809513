"""The single-head MLP policy and its PPO update, port against the JAX
package.

Inputs come from numpy seeds and go through both. Forward passes with
flax weights carried in (interop.mlp_actor_critic_from_flax) agree to
1e-5. One `update` with the legged family's PPO settings (adaptive
learning rate, entropy bonus, no ROA, no DAgger), the minibatch
permutation JAX draws fed through `perm=`: every parameter rtol 1e-4 /
atol 1e-5, every metric rtol 1e-5 / atol 1e-6, the learning rate exact.
The JAX update is jitted (seconds at this size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwbc_tpu.models import mlp_actor_critic as jmlp
from dwbc_tpu.rl import ppo as jppo
from dwbc_tpu.utils import task_registry as jreg
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.models import mlp_actor_critic as mlp
from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.utils import task_registry as reg

NUM_OBS, NUM_ACT = 48, 12
DIMS = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(24, 16))
T, N = 5, 7          # B = 35: with 2 minibatches one row is never used
SMALL = dict(num_learning_epochs=2, num_mini_batches=2)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def make_models(seed=0, **kw):
    kw = {**DIMS, **kw}
    jmodel = jmlp.MlpActorCritic(num_obs=NUM_OBS, num_actions=NUM_ACT, **kw)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, NUM_OBS)))
    model = mlp.MlpActorCritic(num_obs=NUM_OBS, num_actions=NUM_ACT, **kw)
    interop.mlp_actor_critic_from_flax(np_tree(params), model)
    return jmodel, params, model


@pytest.mark.parametrize("activation", ["elu", "tanh"])
def test_forward_matches_flax(activation):
    jmodel, params, model = make_models(seed=1, activation=activation)
    obs = np.random.default_rng(0).normal(size=(9, NUM_OBS)).astype(np.float32)
    jmean, jstd, jval = jmodel.apply(params, jnp.asarray(obs))
    mean, std, val = model(torch.as_tensor(obs))
    assert mean.shape == (9, NUM_ACT) and val.shape == (9, 1)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               rtol=0, atol=1e-5)
    assert np.array_equal(std.detach().numpy(), np.asarray(jstd))
    assert np.abs(np.asarray(jmean)).max() > 1e-3


def test_default_shape_and_latents():
    model = mlp.MlpActorCritic(num_obs=235)
    assert [l.out_features for l in model.actor_layers] == [512, 256, 128, 12]
    assert [l.out_features for l in model.critic_layers] == [512, 256, 128, 1]
    assert torch.equal(model.std.detach(), torch.ones(12))
    obs = torch.zeros((4, 3, 235))
    for latent in (model.priv_latent(obs), model.hist_latent(obs)):
        assert latent.shape == (4, 3, 1) and not latent.any()
    assert torch.equal(model.act_mean(obs[0], True), model.act_mean(obs[0]))


def test_ppo_state_without_history_encoder(tmp_path):
    """A model with no history encoder has no second optimizer (Adam over
    an empty list raises); the state saves, loads and refuses DAgger."""
    cfg = reg._BASE_PPO
    state = ppo.PPOState(cfg, mlp.MlpActorCritic(**DIMS))
    assert state.hist_opt is None and state.hist_params == []
    assert all(p.grad is not None for p in state.params)
    state.counter, state.learning_rate = 4, 1e-3
    path = tmp_path / "ckpt"
    torch.save(state.state_dict(), path)
    other = ppo.PPOState(cfg, mlp.MlpActorCritic(**DIMS))
    other.load_state_dict(torch.load(path, weights_only=True))
    assert other.counter == 4 and other.learning_rate == 1e-3
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="history"):
        ppo.update_dagger(cfg, state, None)


def make_traj(jmodel, params, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    obs = rng.normal(size=(T, N, NUM_OBS)).astype(f32)
    mean = np.asarray(jmodel.apply(params, jnp.asarray(obs),
                                   method="act_mean"))
    std = np.asarray(params["params"]["std"])
    actions = (mean + 0.3 * std * rng.normal(size=mean.shape)).astype(f32)
    jcfg = jppo.PPOConfig(num_heads=1)
    logp = np.asarray(jppo.logp_heads(jcfg, jnp.asarray(actions),
                                      jnp.asarray(mean), jnp.asarray(std)))
    assert logp.shape == (T, N, 1)
    dones = rng.random((T, N)) < 0.2
    z6 = np.zeros((T, N, 6), f32)
    return dict(
        obs=obs, actions=actions,
        rewards=rng.normal(size=(T, N, 1)).astype(f32), dones=dones,
        time_outs=dones & (rng.random((T, N)) < 0.5),
        values=rng.normal(size=(T, N, 1)).astype(f32), log_probs=logp,
        mu=(mean + 0.2 * rng.normal(size=mean.shape)).astype(f32),
        sigma=np.broadcast_to(std, mean.shape).copy(),
        target_arm_torques=z6, current_arm_dof_pos=z6, current_arm_dof_vel=z6)


def run_both(cfg_kw, traj_np, jmodel, jstate, state, key, last_seed=5):
    jcfg, cfg = jppo.PPOConfig(**cfg_kw), ppo.PPOConfig(**cfg_kw)
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj_np.items()})
    ttraj = ppo.Transition(**{k: torch.as_tensor(np.array(v))
                              for k, v in traj_np.items()})
    last = np.random.default_rng(last_seed).normal(size=(N, 1)).astype(
        np.float32)
    jret, jadv = jppo.compute_gae(jcfg, jtraj, jnp.asarray(last))
    jstate2, jmetrics = jax.jit(
        lambda st, tr, ret, adv, k: jppo.update(jcfg, jmodel, st, tr, ret,
                                                adv, k))(
        jstate, jtraj, jret, jadv, key)
    perm = np.array(jax.random.permutation(key, T * N))
    ret, adv = ppo.compute_gae(cfg, ttraj, torch.as_tensor(last))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5,
                               atol=1e-6)
    metrics = ppo.update(cfg, state, ttraj, ret, adv,
                         perm=torch.as_tensor(perm))
    return jstate2, jmetrics, metrics


def assert_same(jstate2, jmetrics, state, metrics):
    for p, want in interop._mlp_leaves(np_tree(jstate2.params), state.model):
        np.testing.assert_allclose(p.detach().numpy(), want, **PARAM_TOL)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    assert state.learning_rate == float(jstate2.learning_rate)
    assert state.counter == int(jstate2.counter)


def base_kw():
    """The legged family's PPO settings at a small epoch count; the port's
    registry must hold the JAX registry's."""
    assert (dataclasses.asdict(reg._BASE_PPO)
            == dataclasses.asdict(jreg._BASE_PPO))
    return dict(dataclasses.asdict(reg._BASE_PPO), **SMALL)


@pytest.fixture(scope="module")
def first_update():
    kw = base_kw()
    jmodel, params, model = make_models(seed=2)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    jstate = jppo.init_state(jppo.PPOConfig(**kw), params)
    state = ppo.PPOState(ppo.PPOConfig(**kw), model)
    out = run_both(kw, make_traj(jmodel, params, seed=3), jmodel, jstate,
                   state, jax.random.PRNGKey(21))
    return (kw, jmodel, start, state) + out


def test_single_head_update_matches(first_update):
    kw, _, start, state, jstate2, jmetrics, metrics = first_update
    assert_same(jstate2, jmetrics, state, metrics)
    # the adaptive rule moved the rate, and every parameter moved
    assert state.learning_rate != pytest.approx(kw["learning_rate"])
    for k, v in state.model.state_dict().items():
        assert not torch.equal(v, start[k]), k
    assert "adv_leg_abs" not in metrics
    assert float(metrics["priv_reg_loss"]) == 0.0


def test_second_update_after_state_carry(first_update):
    """interop.ppo_state_from_numpy carries the JAX state of the MLP
    policy (no history-encoder optimizer) into a fresh port state."""
    kw, jmodel, _, _, jstate1, _, _ = first_update
    adam = jstate1.opt_state[1]
    tree = dict(params=np_tree(jstate1.params),
                opt=dict(mu=np_tree(adam.mu), nu=np_tree(adam.nu),
                         count=np.asarray(adam.count)),
                learning_rate=np.asarray(jstate1.learning_rate),
                counter=np.asarray(jstate1.counter))
    model = mlp.MlpActorCritic(num_obs=NUM_OBS, num_actions=NUM_ACT, **DIMS)
    state = interop.ppo_state_from_numpy(
        tree, ppo.PPOState(ppo.PPOConfig(**kw), model))
    assert state.counter == 1
    some = state.opt.state[model.actor_layers[0].weight]
    assert float(some["step"]) == 4 and float(some["exp_avg"].abs().max()) > 0
    out = run_both(kw, make_traj(jmodel, jstate1.params, seed=8), jmodel,
                   jstate1, state, jax.random.PRNGKey(22), last_seed=9)
    assert_same(*out[:2], state, out[2])
    assert state.counter == 2
