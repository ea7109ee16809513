"""The plain reference against the port on the CPU, from the same inputs:
the Perlin heights, the env step, the policy's forward pass, and the first
training iterations with the PPO update (the readings `correct` compares
come out exactly equal where both run the same plain arithmetic)."""

import numpy as np
import pytest
import torch

from benchmark import run as run_lib
from benchmark import weights as weights_lib
from benchmark.reference import native as ref_native
from benchmark.reference.rl.runner import rank_generators as ref_gens
from benchmark.reference.utils import task_registry as ref_registry
from benchmark.tests.helpers import tiny_cell
from dwbc_tpu_torch import native
from dwbc_tpu_torch.rl.runner import rank_generators
from dwbc_tpu_torch.utils import task_registry


@pytest.mark.parametrize("args,seed", [
    ((60, 100, 15, 25, 0.15), 3),
    ((600, 10000, 150, 2500, 0.15), 2 ** 31 + 7),   # widowGo1's arena
])
def test_perlin_heights_equal_the_native_generator(args, seed):
    ours = ref_native.fractal_noise(*args, seed=seed)
    theirs = native.fractal_noise(*args, seed=seed)
    assert theirs is not None
    np.testing.assert_array_equal(ours, theirs)


def _pair(task, n=8, seed=5):
    env, runner, _ = task_registry.make_runner(task, num_envs=n, seed=seed,
                                               device="cpu")
    renv, rrunner, _ = ref_registry.make_runner(task, num_envs=n, seed=seed,
                                                device="cpu")
    return env, runner, renv, rrunner


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in x.__dataclass_fields__ for t in
                _leaves(getattr(x, k))]
    return []


@pytest.mark.parametrize("task", ["widowGo1", "go1"])
def test_env_step_and_policy_equal_the_port(task):
    env, runner, renv, rrunner = _pair(task)
    shapes = [(k, tuple(p.shape)) for k, p in runner.model.named_parameters()]
    w = weights_lib.make(shapes, [0.9] * env.num_actions, 11, "cpu")
    weights_lib.load(runner.model, w)
    weights_lib.load(rrunner.model, w)
    s, rs = runner.env_state, rrunner.env_state
    obs, robs = runner.obs, rrunner.obs
    torch.testing.assert_close(robs, obs, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(3)
    for step in range(3):
        with torch.no_grad():
            mean = runner.model.act_mean(obs)
            torch.testing.assert_close(rrunner.model.act_mean(robs), mean,
                                       rtol=0, atol=0)
            torch.testing.assert_close(rrunner.model.evaluate(robs),
                                       runner.model.evaluate(obs),
                                       rtol=0, atol=0)
        actions = mean + torch.randn(mean.shape, generator=gen)
        extra = (float(step + 1),) if runner.rollout.has_counter else ()
        s, out = env.step(s, actions, *extra)
        rs, rout = renv.step(rs, actions, *extra)
        for a, b in zip(_leaves(rs) + _leaves(rout), _leaves(s) + _leaves(out)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        obs, robs = out.obs, rout.obs
    assert [g.initial_seed() for g in rank_generators("cpu", 9)] == \
        [g.initial_seed() for g in ref_gens("cpu", 9)]


@pytest.mark.parametrize("workload", ["widowGo1-5000x40", "go1-4096x24"])
def test_first_iterations_read_equal_on_the_cpu(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    result, nums = run_lib.run(cell, 2 ** 31 + 3, 0.5, False, device="cpu")
    assert set(nums) >= set(cell["limits"])
    assert all(v == 0.0 for v in nums.values()), nums
    assert result["correct"] is True
    per_iter = cell["traffic_data"]["num_envs"] * \
        cell["traffic_data"]["num_steps_per_env"]
    # the window ran whole iterations: attempted counts their env steps
    assert result["attempted"] >= per_iter
    assert result["attempted"] % per_iter == 0
    assert result["failed"] == 0
    m = result["metrics"]
    assert set(m) == {"env_steps_per_s", "setup_s"}
    assert m["env_steps_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
