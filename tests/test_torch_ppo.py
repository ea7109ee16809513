"""The port's PPO (dwbc_tpu_torch/rl/ppo.py) against the JAX package's.

Inputs come from numpy seeds and go through both. The JAX updates are
jitted (their scan over 4 minibatch steps compiles in seconds at this
size; run eagerly they take half a minute each). Weights, Adam moments
and counters are carried from the JAX state (interop), the minibatch
permutation is the one JAX draws from its key, fed to the port through
`perm=`.

Tolerances: schedules and entropy 1e-7; GAE rtol 1e-6 (atol 1e-6) at T = 4,
N = 6, where the population and the unbiased std differ by 1 %; after an
update every parameter rtol 1e-4 / atol 1e-5 and every metric rtol 1e-5 /
atol 1e-6; the learning rate exact; parameters the DAgger phase does not
train bit-equal. The bf16 observation store (DWBC_BF16_OBS) is switched on
by patching both packages' `_BF16_OBS`; the JAX package reads its flag
while tracing, so the JAX caches are cleared around those calls.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.models import actor_critic as jac
from dwbc_tpu.rl import ppo as jppo
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.models import actor_critic as ac
from dwbc_tpu_torch.rl import ppo

PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
T, N = 5, 7          # B = 35: with 2 minibatches one row is never used
SMALL = dict(num_learning_epochs=2, num_mini_batches=2)


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def jax_state_np(jstate):
    """The JAX PPOState as the numpy tree interop.ppo_state_from_numpy
    takes."""
    adam = jstate.opt_state[1]
    hadam = jstate.hist_opt_state[1].inner_state[0]
    enc = lambda t: np_tree(t["params"]["actor"]["history_encoder"])
    return dict(
        params=np_tree(jstate.params),
        opt=dict(mu=np_tree(adam.mu), nu=np_tree(adam.nu),
                 count=np.asarray(adam.count)),
        hist_opt=dict(mu=enc(hadam.mu), nu=enc(hadam.nu),
                      count=np.asarray(hadam.count)),
        learning_rate=np.asarray(jstate.learning_rate),
        counter=np.asarray(jstate.counter))


def make_models(adaptive=False, seed=0):
    kw = {}
    if adaptive:
        kw = dict(num_prop=82, adaptive_arm_gains=True,
                  init_std=tuple([0.8, 1.0, 1.0] * 4 + [1.0] * 12))
    jmodel = jac.ActorCritic(**kw)
    num_obs = kw.get("num_prop", 76) * 11 + 24
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, num_obs)))
    return jmodel, params, ac.ActorCritic(**kw), num_obs


def make_traj(jmodel, params, num_obs, t, n, seed, arm=False):
    """A Transition as numpy arrays: random observations, actions around
    the model's means with their log-probs, random rewards, values, dones
    and timeouts; old means a little off the model's so that the KL is
    not zero."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    obs = rng.normal(size=(t, n, num_obs)).astype(f32)
    mean = np.asarray(jmodel.apply(params, jnp.asarray(obs.reshape(t * n, -1)),
                                   False, method="act_mean"))
    na = mean.shape[-1]
    mean = mean.reshape(t, n, na)
    std = np.asarray(params["params"]["std"])
    actions = (mean + 0.3 * std * rng.normal(size=mean.shape)).astype(f32)
    logp = np.asarray(jac.log_prob_per_head(jnp.asarray(actions),
                                            jnp.asarray(mean),
                                            jnp.asarray(std)))
    dones = rng.random((t, n)) < 0.2
    arm6 = ((lambda s: (s * rng.normal(size=(t, n, 6))).astype(f32)) if arm
            else (lambda s: np.zeros((t, n, 6), f32)))
    return dict(
        obs=obs, actions=actions,
        rewards=rng.normal(size=(t, n, 2)).astype(f32),
        dones=dones, time_outs=dones & (rng.random((t, n)) < 0.5),
        values=rng.normal(size=(t, n, 2)).astype(f32), log_probs=logp,
        mu=(mean + 0.2 * rng.normal(size=mean.shape)).astype(f32),
        sigma=np.broadcast_to(std, mean.shape).copy(),
        # physically plausible supervision data: targets within the arm's
        # effort class, small joint state
        target_arm_torques=arm6(5.0), current_arm_dof_pos=arm6(0.3),
        current_arm_dof_vel=arm6(1.0))


def both(traj_np):
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj_np.items()})
    ttraj = ppo.Transition(**{k: torch.as_tensor(np.array(v))
                              for k, v in traj_np.items()})
    return jtraj, ttraj


def assert_params_match(jparams, model, **tol):
    for p, want in interop._flax_leaves(np_tree(jparams), model):
        np.testing.assert_allclose(p.detach().numpy(), want, **tol)


def assert_metrics_match(jmetrics, metrics):
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   **METRIC_TOL)


def run_both(cfg_kw, traj_np, jmodel, jstate, state, key, arm_default=None,
             last_seed=5):
    """One compute_gae + update on each side from the given states."""
    jcfg, cfg = jppo.PPOConfig(**cfg_kw), ppo.PPOConfig(**cfg_kw)
    jtraj, ttraj = both(traj_np)
    n = traj_np["dones"].shape[1]
    last = np.random.default_rng(last_seed).normal(size=(n, 2)).astype(
        np.float32)
    B = traj_np["dones"].size
    jarm = (None if arm_default is None
            else tuple(jnp.asarray(a) for a in arm_default))
    jret, jadv = jppo.compute_gae(jcfg, jtraj, jnp.asarray(last))
    jstate2, jmetrics = jax.jit(
        lambda st, tr, ret, adv, k: jppo.update(
            jcfg, jmodel, st, tr, ret, adv, k, arm_default=jarm))(
        jstate, jtraj, jret, jadv, key)
    perm = np.asarray(jax.random.permutation(key, B))
    ret, adv = ppo.compute_gae(cfg, ttraj, torch.as_tensor(last))
    metrics = ppo.update(
        cfg, state, ttraj, ret, adv, perm=torch.as_tensor(perm),
        arm_default=(None if arm_default is None
                     else tuple(torch.as_tensor(a) for a in arm_default)))
    return jstate2, jmetrics, metrics


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter", [0, 1, 999, 1500, 3000, 6500, 12000])
def test_schedules_match(counter):
    kw = dict(torque_supervision_schedule=(0.7, 1000.0, 1000.0))
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    c = jnp.asarray(counter, jnp.int32)
    for name in ("mixing_ratio", "torque_supervision_weight",
                 "priv_reg_coef"):
        np.testing.assert_allclose(
            getattr(ppo, name)(cfg, counter),
            float(getattr(jppo, name)(jcfg, c)), rtol=0, atol=1e-7,
            err_msg=name)


@pytest.mark.parametrize("num_heads", [1, 2])
def test_entropy_heads_match(num_heads):
    std = np.random.default_rng(2).uniform(0.1, 1.4, 18).astype(np.float32)
    jcfg, cfg = (jppo.PPOConfig(num_heads=num_heads),
                 ppo.PPOConfig(num_heads=num_heads))
    want = np.asarray(jppo.entropy_heads(jcfg, jnp.asarray(std), (9,)))
    got = ppo.entropy_heads(cfg, torch.as_tensor(std), (9,))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)


def test_compute_gae_matches():
    t, n = 4, 6
    rng = np.random.default_rng(4)
    f32 = np.float32
    dones = rng.random((t, n)) < 0.3
    dones[1, 2] = dones[2, 4] = True
    time_outs = dones & (rng.random((t, n)) < 0.6)
    time_outs[1, 2] = True
    z6 = np.zeros((t, n, 6), f32)
    traj_np = dict(
        obs=np.zeros((t, n, 3), f32), actions=np.zeros((t, n, 18), f32),
        rewards=rng.normal(size=(t, n, 2)).astype(f32), dones=dones,
        time_outs=time_outs, values=rng.normal(size=(t, n, 2)).astype(f32),
        log_probs=np.zeros((t, n, 2), f32), mu=np.zeros((t, n, 18), f32),
        sigma=np.ones((t, n, 18), f32), target_arm_torques=z6,
        current_arm_dof_pos=z6, current_arm_dof_vel=z6)
    jtraj, ttraj = both(traj_np)
    last = rng.normal(size=(n, 2)).astype(f32)
    jret, jadv = jppo.compute_gae(jppo.PPOConfig(), jtraj, jnp.asarray(last))
    ret, adv = ppo.compute_gae(ppo.PPOConfig(), ttraj, torch.as_tensor(last))
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6,
                               atol=1e-6)
    # the unbiased std would be off by sqrt(48 / 47) - 1 = 1 %
    raw = ret - ttraj.values
    wrong = (raw - raw.mean()) / (raw.std() + 1e-8)
    assert float((wrong - adv).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def first_update():
    """One update with the fixed learning rate on both sides, from flax
    weights carried in. Kept for the second-update test."""
    jmodel, params, model, num_obs = make_models()
    interop.actor_critic_from_flax(np_tree(params), model)
    traj_np = make_traj(jmodel, params, num_obs, T, N, seed=1)
    jstate = jppo.init_state(jppo.PPOConfig(**SMALL), params)
    state = ppo.PPOState(ppo.PPOConfig(**SMALL), model)
    jstate2, jmetrics, metrics = run_both(
        SMALL, traj_np, jmodel, jstate, state, jax.random.PRNGKey(11))
    return jmodel, num_obs, jstate2, jmetrics, state, metrics


def test_update_matches_fixed_lr(first_update):
    jmodel, _, jstate2, jmetrics, state, metrics = first_update
    assert_params_match(jstate2.params, state.model, **PARAM_TOL)
    assert_metrics_match(jmetrics, metrics)
    assert state.counter == int(jstate2.counter) == 1
    assert state.learning_rate == float(jstate2.learning_rate)
    # the update moved the weights (so the comparison means something)
    fresh = make_models()[1]
    moved = np.abs(np.asarray(jstate2.params["params"]["critic"]["Dense_0"]
                              ["kernel"])
                   - np.asarray(fresh["params"]["critic"]["Dense_0"]["kernel"]))
    assert moved.max() > 1e-4


def test_update_matches_adaptive_lr():
    kw = dict(SMALL, schedule="adaptive", desired_kl=0.01, learning_rate=5e-4)
    jmodel, params, model, num_obs = make_models(seed=3)
    interop.actor_critic_from_flax(np_tree(params), model)
    traj_np = make_traj(jmodel, params, num_obs, T, N, seed=6)
    jstate = jppo.init_state(jppo.PPOConfig(**kw), params)
    state = ppo.PPOState(ppo.PPOConfig(**kw), model)
    jstate2, jmetrics, metrics = run_both(
        kw, traj_np, jmodel, jstate, state, jax.random.PRNGKey(12))
    assert float(jstate2.learning_rate) != pytest.approx(5e-4)  # it moved
    assert state.learning_rate == float(jstate2.learning_rate)
    assert_params_match(jstate2.params, state.model, **PARAM_TOL)
    assert_metrics_match(jmetrics, metrics)


def test_second_update_after_state_carry(first_update):
    """ppo_state_from_numpy carries a JAX state with non-zero Adam moments
    into a fresh port state; a second update on new data then matches."""
    jmodel, num_obs, jstate1, _, _, _ = first_update
    model = ac.ActorCritic()
    state = interop.ppo_state_from_numpy(
        jax_state_np(jstate1), ppo.PPOState(ppo.PPOConfig(**SMALL), model))
    assert state.counter == 1
    some = state.opt.state[model.critic.backbone_layers[0].weight]
    assert float(some["step"]) == 4 and float(some["exp_avg"].abs().max()) > 0
    traj_np = make_traj(jmodel, jstate1.params, num_obs, T, N, seed=21)
    jstate2, jmetrics, metrics = run_both(
        SMALL, traj_np, jmodel, jstate1, state, jax.random.PRNGKey(13),
        last_seed=8)
    assert_params_match(jstate2.params, model, **PARAM_TOL)
    assert_metrics_match(jmetrics, metrics)
    assert state.counter == int(jstate2.counter) == 2


def test_update_dagger_matches():
    jmodel, params, model, num_obs = make_models(seed=5)
    interop.actor_critic_from_flax(np_tree(params), model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    traj_np = make_traj(jmodel, params, num_obs, T, N, seed=7)
    jtraj, ttraj = both(traj_np)
    jcfg, cfg = jppo.PPOConfig(**SMALL), ppo.PPOConfig(**SMALL)
    jstate = jppo.init_state(jcfg, params)
    state = ppo.PPOState(cfg, model)
    key = jax.random.PRNGKey(14)
    jstate2, jmetrics = jax.jit(
        lambda st, tr, k: jppo.update_dagger(jcfg, jmodel, st, tr, k))(
        jstate, jtraj, key)
    perm = torch.as_tensor(np.asarray(jax.random.permutation(key, T * N)))
    metrics = ppo.update_dagger(cfg, state, ttraj, perm=perm)
    assert_metrics_match(jmetrics, metrics)
    assert_params_match(jstate2.params, model, **PARAM_TOL)
    assert state.counter == int(jstate2.counter) == 1
    moved = 0
    for k, v in model.state_dict().items():
        if "history_encoder" in k:
            moved += int(not torch.equal(v, before[k]))
        else:   # std and the critic included
            assert torch.equal(v, before[k]), k
    assert moved == 8   # every weight and bias of the history encoder


@pytest.mark.parametrize("bad_data", [False, True])
def test_torque_branch_matches(bad_data):
    """The OSC torque-supervision branch with the adaptive model, on the
    data of the JAX package's fixed-data supervision test (made with
    numpy); then with a non-finite and a 1e4 N m target in the batch."""
    kw = dict(SMALL, torque_supervision=True, adaptive_arm_gains=True,
              torque_supervision_schedule=(1.0, 1e6, 1e6),
              min_policy_std=tuple([0.15, 0.25, 0.25] * 4 + [0.2] * 3
                                   + [0.05] * 3 + [0.05] * 6))
    jmodel, params, model, num_obs = make_models(adaptive=True, seed=3)
    interop.actor_critic_from_flax(np_tree(params), model)
    t, n = 4, 8
    traj_np = make_traj(jmodel, params, num_obs, t, n, seed=9, arm=True)
    if bad_data:
        traj_np["target_arm_torques"][0, 0, 0] = np.nan
        traj_np["target_arm_torques"][1, 2, 3] = 1e4
        traj_np["current_arm_dof_vel"][2, 5, 1] = np.inf
    f32 = np.float32
    arm_default = (np.full(6, 5.0, f32), np.full(6, 0.5, f32),
                   np.zeros(6, f32), np.full(6, 0.5, f32))
    jstate = jppo.init_state(jppo.PPOConfig(**kw), params)
    state = ppo.PPOState(ppo.PPOConfig(**kw), model)
    jstate2, jmetrics, metrics = run_both(
        kw, traj_np, jmodel, jstate, state, jax.random.PRNGKey(15),
        arm_default=arm_default)
    assert float(metrics["arm_torques_loss"]) > 0
    assert float(metrics["torque_supervision_weight"]) == 1.0
    for p in model.parameters():
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all()
    assert_metrics_match(jmetrics, metrics)
    assert_params_match(jstate2.params, model, **PARAM_TOL)


@pytest.mark.parametrize("floor_len,clamped", [(18, True), (12, False)])
def test_enforce_min_std(floor_len, clamped):
    floor = tuple(np.linspace(0.1, 0.5, floor_len).tolist())
    jcfg, cfg = (jppo.PPOConfig(min_policy_std=floor),
                 ppo.PPOConfig(min_policy_std=floor))
    std = np.linspace(0.45, 0.05, 18).astype(np.float32)
    model = ac.ActorCritic()
    with torch.no_grad():
        model.std.copy_(torch.as_tensor(std))
    ppo.enforce_min_std(cfg, model)
    want = jppo.enforce_min_std(
        jcfg, {"params": {"std": jnp.asarray(std), "other": jnp.ones(3)}})
    np.testing.assert_array_equal(model.std.detach().numpy(),
                                  np.asarray(want["params"]["std"]))
    assert (not np.array_equal(model.std.detach().numpy(), std)) == clamped


# ---------------------------------------------------------------------------
# the bf16 observation store (DWBC_BF16_OBS)


@pytest.fixture(scope="module")
def bf16_updates():
    """first_update's case with the bf16 store on in both packages, and the
    port's update with the store off from the same start."""
    jmodel, params, model, num_obs = make_models()
    interop.actor_critic_from_flax(np_tree(params), model)
    model_f32 = ac.ActorCritic()
    interop.actor_critic_from_flax(np_tree(params), model_f32)
    traj_np = make_traj(jmodel, params, num_obs, T, N, seed=1)
    jstate = jppo.init_state(jppo.PPOConfig(**SMALL), params)
    state = ppo.PPOState(ppo.PPOConfig(**SMALL), model)
    key = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jppo, "_BF16_OBS", True)
        mp.setattr(ppo, "_BF16_OBS", True)
        jax.clear_caches()
        try:
            jstate2, jmetrics, metrics = run_both(
                SMALL, traj_np, jmodel, jstate, state, key)
        finally:
            jax.clear_caches()
    state_f32 = ppo.PPOState(ppo.PPOConfig(**SMALL), model_f32)
    cfg = ppo.PPOConfig(**SMALL)
    ttraj = both(traj_np)[1]
    last = np.random.default_rng(5).normal(size=(N, 2)).astype(np.float32)
    ret, adv = ppo.compute_gae(cfg, ttraj, torch.as_tensor(last))
    perm = torch.as_tensor(np.asarray(jax.random.permutation(key, T * N)))
    ppo.update(cfg, state_f32, ttraj, ret, adv, perm=perm)
    return jstate2, jmetrics, state, metrics, state_f32


def test_update_matches_with_bf16_obs_store(bf16_updates):
    jstate2, jmetrics, state, metrics, _ = bf16_updates
    assert_params_match(jstate2.params, state.model, **PARAM_TOL)
    assert_metrics_match(jmetrics, metrics)
    assert state.counter == int(jstate2.counter) == 1
    assert state.learning_rate == float(jstate2.learning_rate)


def test_bf16_obs_store_changes_the_update(bf16_updates):
    """The store rounds the observations the update reads: its result
    differs from the float32 update's, so the match above means
    something."""
    _, _, state, _, state_f32 = bf16_updates
    diff = max(float((a - b).detach().abs().max()) for a, b in
               zip(state.model.parameters(), state_f32.model.parameters()))
    assert diff > 1e-6


def test_update_dagger_ignores_bf16_obs_store(monkeypatch):
    """The DAgger phase reads float32 observations with the flag on, as in
    the JAX package: bit-equal parameters and loss."""
    jmodel, params, _, num_obs = make_models(seed=5)
    traj_np = make_traj(jmodel, params, num_obs, T, N, seed=7)
    perm = torch.as_tensor(np.random.default_rng(2).permutation(T * N))
    cfg = ppo.PPOConfig(**SMALL)
    results = []
    for store in (False, True):
        monkeypatch.setattr(ppo, "_BF16_OBS", store)
        model = ac.ActorCritic()
        interop.actor_critic_from_flax(np_tree(params), model)
        state = ppo.PPOState(cfg, model)
        metrics = ppo.update_dagger(cfg, state, both(traj_np)[1], perm=perm)
        results.append((metrics["hist_latent_loss"], model.state_dict()))
    (loss0, sd0), (loss1, sd1) = results
    assert torch.equal(loss0, loss1)
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k


def test_bf16_rounding_matches_xla():
    """float32 -> bfloat16 rounds to nearest, ties to even, overflow to
    inf, in both frameworks: NaN, +-inf, +-0, ties either way, the largest
    float32, subnormals. Finite and infinite values agree bit for bit; a
    NaN stays a NaN (torch's CPU cast and XLA's give different NaN bits,
    which no arithmetic on them can tell apart)."""
    f32 = np.float32
    x = np.concatenate([
        np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                  1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                  -(1 + 3 * 2 ** -8), 1 + 2 ** -8 + 2 ** -20,
                  np.finfo(f32).max, 3.39e38, 1e-40, 2.0 ** -133], f32),
        np.array([0x7F800001, 0xFFC12345], np.uint32).view(f32),
        np.random.default_rng(0).normal(size=64).astype(f32)])
    got = torch.as_tensor(x).to(torch.bfloat16)
    want = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16)[finite],
        np.asarray(want).view(np.uint16)[finite])
