"""The port's benchmark harness (dwbc_tpu_torch/bench.py) on the CPU: its
JSON line at a small size (every key, the median over the windows, the
device metrics null), its refusal to run without a card, its state-byte
count against the root bench.py's formula over the JAX env's state, and
its analytic operation count against torch's FlopCounterMode."""

import json
import statistics
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dwbc_tpu_torch import bench
from dwbc_tpu_torch.models.actor_critic import ActorCritic
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
from dwbc_tpu_torch.utils import task_registry

TASK_KEYS = {
    "metric", "value", "unit", "num_envs", "steps", "iters", "runs", "min",
    "max", "samples", "collection_time_s", "learn_time_s", "collect_s_runs",
    "learn_s_runs", "iters_per_s", "state_bytes_per_env_step",
    "collect_hbm_gbps", "hbm_util_vs_peak", "model_flops_per_iter",
    "mfu_vs_f32_peak", "contact_kernel"}
KERNEL_KEYS = {"shape", "launches_per_iter", "ms", "plain_ms", "bound_ms",
               "bound_by", "share_of_bound"}


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """TensorBoard's event writer imports TensorFlow where it is
    installed, which takes many seconds, and uses none of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: beside other test workers on the same
    machine, one thread per core only oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tasks", ["go1,go1_flat_lstm", "go1_flat_lstm,go1"])
def test_cpu_line(tasks, capsys):
    """Two tasks (the MLP runner and the recurrent one) at 16 envs x 2
    steps, two interleaved windows of one iteration each."""
    ret = bench.main(["--cpu", "--task", tasks, "--num_envs", "16",
                      "--steps", "2", "--warmup", "1", "--iters", "1",
                      "--repeats", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(ret))
    assert TASK_KEYS - {"steps", "iters"} <= set(line)
    assert line["device"] == dict(platform="cpu", name="cpu",
                                  power_limit_w=None, count=1)
    assert [t["task"] for t in line["tasks"]] == tasks.split(",")
    assert "trace" not in line
    for t in line["tasks"]:
        assert set(t) == TASK_KEYS | {"task"}
        assert set(t["contact_kernel"]) == KERNEL_KEYS
        assert (t["num_envs"], t["steps"], t["iters"]) == (16, 2, 1)
        assert t["samples"] == len(t["runs"]) == 2
        assert t["value"] == statistics.median(t["runs"])
        assert t["min"] == min(t["runs"]) and t["max"] == max(t["runs"])
        assert len(t["collect_s_runs"]) == len(t["learn_s_runs"]) == 2
        assert all(x > 0 for x in t["runs"] + t["collect_s_runs"]
                   + t["learn_s_runs"])
        for k in ("collect_hbm_gbps", "hbm_util_vs_peak", "mfu_vs_f32_peak"):
            assert t[k] is None, k
        k = t["contact_kernel"]
        assert k["shape"] == [92, 13, 16] and k["bound_by"] == "bytes"
        assert k["ms"] is k["plain_ms"] is k["share_of_bound"] is None
        # the plain law runs on CPU tensors: no kernel launches
        assert k["launches_per_iter"] == 0
        assert t["state_bytes_per_env_step"] > 0
    mlp, rec = sorted(line["tasks"], key=lambda t: t["task"])
    # go1's MLP 235-512-256-128-12 and critic, 5 epochs
    assert mlp["model_flops_per_iter"] == (
        2 * (235 * 512 + 512 * 256 + 256 * 128) * 2
        + 2 * (128 * 12 + 128 * 1)) * 16 * 2 * 16
    assert rec["model_flops_per_iter"] > 0
    first = line["tasks"][0]
    assert line["value"] == first["value"]
    assert line["metric"] == first["metric"]


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--task", "go1", "--num_envs", "4"])


def test_state_bytes_match_bench_py_formula(monkeypatch):
    """state_bytes_per_env_step of widowGo1 at N = 4 equals the root
    bench.py's formula over the JAX env's state leaves at the same N (their
    shapes and dtypes from jax.eval_shape of its reset; the JAX env built
    with the port's effective masses, as tests/test_torch_play.py does)."""
    from dwbc_tpu.sim import engine as jengine
    from dwbc_tpu.utils import task_registry as jregistry
    from dwbc_tpu_torch.sim import engine

    def fast_ctx(model, q_ref):
        ctx = engine.build_ctx(model, torch.as_tensor(np.array(q_ref)))
        return jengine.PhysCtx(*(jnp.asarray(t.numpy()) for t in ctx))

    monkeypatch.setattr(jengine, "build_ctx", fast_ctx)
    n = 4
    jenv, _ = jregistry.make_env("widowGo1", num_envs=n)
    es, _ = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                         jax.eval_shape(jenv.reset, jax.random.PRNGKey(0)))
    # bench.py:80-91, verbatim
    substep_leaves = [es.robot.q, es.robot.qd]
    if hasattr(es, "box"):
        substep_leaves += [es.box.q, es.box.qd]
    if hasattr(es, "contact_carry"):
        substep_leaves += list(jax.tree.leaves(es.contact_carry))
    substep_bytes = sum(x.nbytes for x in substep_leaves)
    state_bytes = sum(
        x.nbytes for x in jax.tree.leaves(es) if hasattr(x, "nbytes"))
    passes = getattr(jenv.cfg.control, "decimation", 4)
    want = (2.0 * substep_bytes * passes + 2.0 * state_bytes) / n

    env, _ = task_registry.make_env("widowGo1", n, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0))
    got = bench.bytes_per_env_step(state, env.cfg.control.decimation) / n
    assert got == want


@pytest.mark.parametrize("make, width", [
    (lambda: ActorCritic(), 76 * 11 + 24),
    (lambda: ActorCritic(adaptive_arm_gains=True, num_prop=82,
                         init_std=(1.0,) * 24), 82 * 11 + 24),
    (lambda: MlpActorCritic(num_obs=235, num_actions=12), 235),
    (lambda: ActorCriticRecurrent(num_obs=48, num_actions=12,
                                  rnn_hidden_size=64, actor_hidden_dims=(64,),
                                  critic_hidden_dims=(64,)), 48),
    (lambda: ActorCriticRecurrent(num_obs=48, num_actions=12, rnn_type="gru",
                                  rnn_hidden_size=32), 48)],
    ids=["widowGo1", "adaptive", "mlp", "lstm", "gru"])
def test_forward_flops_match_flop_counter(make, width):
    """The analytic count of one policy forward equals torch's
    FlopCounterMode over model(obs) at batch 8."""
    torch.manual_seed(0)
    model = make()
    obs = torch.randn(8, width)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(obs)
    assert counter.get_total_flops() == 8 * bench.forward_flops(model)
