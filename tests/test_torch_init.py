"""A fresh policy of the port starts where a fresh flax policy of the JAX
package starts: every Dense / Conv kernel lecun_normal (a normal truncated
at two standard deviations, variance 1 / fan_in), every bias zero, each
gate's recurrent kernel of the LSTM / GRU cells orthogonal, the std at
its init value. The two frameworks draw different numbers, so the
distributions are compared: the statistics of the flax parameters (the
reference) and of the port's, leaf for leaf through interop's pairing.

Tolerance: a kernel's mean of w^2 x fan_in within 5 standard errors of 1
(the standard error from the truncated normal's fourth moment and the
kernel's size), the same over all kernels of a model pooled; |w| at most
2 x sqrt(1 / fan_in) / 0.8796; recurrent blocks W W^T = I within 1e-5.
torch's default initialisation (uniform weights with a third of that
variance, uniform biases) fails all but the bound."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.models import actor_critic as jac
from dwbc_tpu.models import actor_critic_recurrent as jrec
from dwbc_tpu.models import mlp_actor_critic as jmlp
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.models.actor_critic import ActorCritic
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic

TRUNC_STD = 0.87962566103423978


def _x2_sd():
    """Standard deviation of x^2 for x a standard normal truncated to
    [-2, 2] and scaled to unit variance."""
    z = np.linspace(-2.0, 2.0, 400001)
    p = np.exp(-0.5 * z * z)
    p /= p.sum()
    x2 = (z / TRUNC_STD) ** 2
    return float(np.sqrt((p * x2 * x2).sum() - (p * x2).sum() ** 2))


X2_SD = _x2_sd()


def build(kind):
    """(flax parameter tree as numpy, fresh port model)."""
    torch.manual_seed(0)
    key = jax.random.PRNGKey(0)
    if kind in ("widowGo1", "widowGo1_adaptive"):
        kw = {}
        if kind == "widowGo1_adaptive":
            kw = dict(num_prop=82, adaptive_arm_gains=True,
                      init_std=tuple([0.8, 1.0, 1.0] * 4 + [1.0] * 12))
        num_obs = kw.get("num_prop", 76) * 11 + 24
        params = jac.ActorCritic(**kw).init(key, jnp.zeros((2, num_obs)))
        model = ActorCritic(**kw)
    elif kind == "mlp":
        params = jmlp.MlpActorCritic(num_obs=235).init(
            key, jnp.zeros((2, 235)))
        model = MlpActorCritic(num_obs=235)
    else:
        kw = dict(num_obs=48, rnn_type=kind, rnn_hidden_size=64)
        params = jrec.ActorCriticRecurrent(**kw).init(key,
                                                      jnp.zeros((2, 48)))
        model = ActorCriticRecurrent(**kw)
    return jax.tree_util.tree_map(np.asarray, params), model


def recurrent_gates(model):
    """{id(weight): number of gate blocks} of the recurrent kernels."""
    out = {}
    for cell in (getattr(model, "memory_a", None),
                 getattr(model, "memory_c", None)):
        if cell is None:
            continue
        if model.rnn_type == "lstm":
            out[id(cell.wh.weight)] = 4
        else:
            out[id(cell.wh.weight)] = 2
            out[id(cell.whn.weight)] = 1
    return out


def check(leaves, gates, std_param, who):
    """Asserts the flax initialisation's statistics on (param, array)
    pairs; returns the number of kernels checked."""
    pooled, count, kernels = 0.0, 0, 0
    for param, w in leaves:
        w = np.asarray(w, np.float64)
        if param is std_param:
            continue
        if id(param) in gates:
            for block in np.split(w, gates[id(param)], 0):
                np.testing.assert_allclose(
                    block @ block.T, np.eye(block.shape[0]), atol=1e-5,
                    err_msg=f"{who}: recurrent block not orthogonal")
            continue
        if w.ndim == 1:
            assert not w.any(), f"{who}: a bias is not zero"
            continue
        fan_in = int(np.prod(w.shape[1:]))
        s = float(np.mean(w * w)) * fan_in
        assert abs(s - 1.0) < 5 * X2_SD / np.sqrt(w.size), (who, w.shape, s)
        assert np.abs(w).max() <= 2 * np.sqrt(1.0 / fan_in) / TRUNC_STD \
            * (1 + 1e-6), (who, w.shape)
        pooled += s * w.size
        count += w.size
        kernels += 1
    assert abs(pooled / count - 1.0) < 5 * X2_SD / np.sqrt(count), (
        who, pooled / count)
    return kernels


@pytest.mark.parametrize("kind", ["widowGo1", "widowGo1_adaptive", "mlp",
                                  "lstm", "gru"])
def test_fresh_policy_is_initialised_as_flax_initialises(kind):
    params, model = build(kind)
    pairs = list(interop._leaves_of(model)(params, model))
    gates = recurrent_gates(model)
    n_jax = check(pairs, gates, model.std, "flax")
    n_port = check(((p, p.detach().numpy()) for p, _ in pairs), gates,
                   model.std, "port")
    assert n_jax == n_port > 0
    if kind in ("lstm", "gru"):
        assert len(gates) == (2 if kind == "lstm" else 4)
    want = next(w for p, w in pairs if p is model.std)
    np.testing.assert_array_equal(model.std.detach().numpy(), want)
