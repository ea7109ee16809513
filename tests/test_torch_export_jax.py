"""The port's exported programs against the JAX package's model: the
JAX parameters of go1_flat's MlpActorCritic and widowGo1's ActorCritic
carried into the port through interop, exported with runner/export.py,
loaded back and held against the JAX model's act_mean(obs, True) and
hist_latent (atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu_torch import interop
from dwbc_tpu_torch.runner import export as export_mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(task):
    """(JAX model, its parameters, the port model carrying them, obs
    width): go1_flat's MlpActorCritic, widowGo1's ActorCritic."""
    if task == "go1_flat":
        from dwbc_tpu.models.mlp_actor_critic import MlpActorCritic as J
        from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
        jmodel, model, num_obs = J(num_obs=48, num_actions=12), \
            MlpActorCritic(48, 12), 48
        load = interop.mlp_actor_critic_from_flax
    else:
        from dwbc_tpu.models.actor_critic import ActorCritic as J
        from dwbc_tpu_torch.models.actor_critic import ActorCritic
        jmodel, model, num_obs = J(), ActorCritic(), 860
        load = interop.actor_critic_from_flax
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, num_obs)))
    load(jax.tree.map(np.asarray, params), model)
    return jmodel, params, model, num_obs


@pytest.mark.parametrize("task", ["go1_flat", "widowGo1"])
def test_export_matches_jax_model(task, tmp_path):
    """The JAX package's parameters carried into the port, exported; the
    loaded programs against the JAX model's act_mean(obs, True) and
    hist_latent at batch 3 (atol 1e-5)."""
    jmodel, params, model, num_obs = _models(task)
    out_dir = str(tmp_path / "export")
    export_mod.export_model(model, num_obs, out_dir)
    obs = np.random.default_rng(0).normal(size=(3, num_obs)).astype(np.float32)
    for name, method, args in (("policy", "act_mean", (True,)),
                               ("hist_encoder", "hist_latent", ())):
        program = export_mod.load_artifact(out_dir, name, "cpu")
        want = np.asarray(jax.jit(lambda p, o: jmodel.apply(
            p, o, *args, method=method))(params, jnp.asarray(obs)))
        with torch.no_grad():
            got = program(torch.as_tensor(obs)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


