"""The port's play npz against the JAX play.py's: the same keys, dtypes
and shapes for the same arguments (go1_flat and widowGo1, 2 envs, 5
steps)."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu_torch.runner import play as play_mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("task", ["go1_flat", "widowGo1"])
def test_play_npz_layout_matches_jax(task, tmp_path, monkeypatch):
    """The port's play npz has the JAX play.py's keys, dtypes and shapes
    for the same arguments (2 envs, 5 steps). The JAX play runs its own
    code over its own env's state shapes and dtypes (jax.eval_shape of
    reset and of the EE lookup), with the step keeping the state: a
    compiled JAX env step takes minutes on the CPU, and the values differ
    between the packages by their random draws anyway. The JAX env is
    built with the port's effective masses (equal at rtol 1e-5,
    tests/test_torch_engine.py) instead of its own eager build_ctx."""
    from dwbc_tpu.runner import play as jplay
    from dwbc_tpu.sim import engine as jengine
    from dwbc_tpu.utils import task_registry as jregistry
    from dwbc_tpu_torch.sim import engine

    def fast_ctx(model, q_ref):
        ctx = engine.build_ctx(model, torch.as_tensor(np.asarray(q_ref)))
        return jengine.PhysCtx(*(jnp.asarray(t.numpy()) for t in ctx))

    monkeypatch.setattr(jengine, "build_ctx", fast_ctx)
    n, steps = 2, 5
    jenv, _ = jregistry.make_env(task, num_envs=n)
    zeros = lambda s: jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), s)
    state0, obs0 = zeros(jax.eval_shape(jenv.reset, jax.random.PRNGKey(0)))
    step_out = types.SimpleNamespace(obs=obs0, rew=jnp.zeros((n,)))

    class Env:
        """The JAX env with reset, step and the EE lookup abstracted."""

        def __getattr__(self, name):
            return getattr(jenv, name)

        def reset(self, key):
            return state0, obs0

        def step(self, state, actions, *counter):
            return state, step_out

        def _ee_world(self, q):
            return zeros(jax.eval_shape(jenv._ee_world, q))

    if hasattr(jenv, "curriculum"):
        Env.curriculum = jenv.curriculum

    class Runner:
        def get_inference_policy(self, stochastic=False):
            return lambda obs, key=None: jnp.zeros((n, jenv.num_actions))

    monkeypatch.setattr(jregistry, "make_runner",
                        lambda *a, **k: (Env(), Runner(), None))
    jout = str(tmp_path / "jax.npz")
    monkeypatch.setattr("sys.argv", ["play", "--task", task, "--num_envs",
                                     str(n), "--steps", str(steps),
                                     "--out", jout])
    jplay.main()
    out = str(tmp_path / "port.npz")
    play_mod.play(task, num_envs=n, steps=steps, out=out, device="cpu",
                  plot=False)
    want, got = np.load(jout), np.load(out)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
