"""The port's task registry and the single-head family's way through the
shared rollout and runner: port twins of tests/test_smoke.py, the
registry held against the JAX package's, and the repairs that let a
single-reward env through `Rollout` (no `extras` on its step output, the
`terrain_level` statistic) and `OnPolicyRunner` (an MLP policy, a state
without a history-encoder optimizer)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from dwbc_tpu.utils import task_registry as jreg
from dwbc_tpu_torch.envs.vec_env import VecEnv
from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.rl.recurrent import RecurrentRunner
from dwbc_tpu_torch.rl.runner import OnPolicyRunner, Rollout
from dwbc_tpu_torch.runner import train
from dwbc_tpu_torch.utils.task_registry import TASKS, make_env, make_runner

ALL = ["widowGo1", "widowGo1_flat", "widowGo1_adaptive", "go1", "go1_flat",
       "a1", "a1_flat", "anymal_c_rough", "anymal_c_flat", "anymal_b",
       "cassie", "go1_flat_lstm"]
SPHERES = {"go1": 92, "a1": 76, "anymal_b": 28, "anymal_c_rough": 22,
           "cassie": 5}


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """TensorBoard's event writer imports TensorFlow where it is
    installed, which takes many seconds, and uses none of it: without it
    the writer takes its own stub and writes the same event files."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The envs here are small: beside other test workers on the same
    machine, one thread per core only oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_complete():
    """The JAX registry's names, each with the same runner settings and
    PPO config."""
    assert list(TASKS) == list(jreg.TASKS) and set(ALL) <= set(TASKS)
    assert len(TASKS) == len(ALL) == 12
    for name, spec in TASKS.items():
        want = jreg.TASKS[name]
        for f in ("num_steps_per_env", "default_num_envs", "experiment_name",
                  "policy_class_name"):
            assert getattr(spec, f) == getattr(want, f), (name, f)
        assert (dataclasses.asdict(spec.ppo_cfg)
                == dataclasses.asdict(want.ppo_cfg)), name
    assert TASKS["go1"].default_num_envs == 4096
    assert TASKS["go1"].num_steps_per_env == 24


@pytest.mark.parametrize("task", list(TASKS))
def test_every_task_builds_and_steps(task):
    n = 6
    env, spec = make_env(task, num_envs=n, seed=3, device="cpu")
    assert isinstance(env, VecEnv) and env.num_envs == n
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (n, env.num_obs) and bool(torch.isfinite(obs).all())
    args = (3.0,) if hasattr(env, "arm_reward_names") else ()
    state, out = env.step(state, torch.zeros((n, env.num_actions)), *args)
    assert out.obs.shape == (n, env.num_obs)
    assert bool(torch.isfinite(out.obs).all())
    assert bool(torch.isfinite(out.rew).all())
    assert spec.ppo_cfg.num_heads == (2 if args else 1)
    if task in SPHERES:
        assert len(env.model.geom_body) == SPHERES[task]
        assert (env.model.nb, env.model.nj) == (13, 12)
        assert env.num_obs == (235 if task != "cassie" else 169)
    if task.endswith(("_flat", "_lstm")) and not args:
        assert env.num_obs == 48 and env.grid is None


@pytest.mark.parametrize("task", ["go1_flat"])
def test_zero_action_rollout(task):
    env, spec = make_env(task, num_envs=10, seed=42, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (10, env.num_obs)
    zeros = torch.zeros((10, env.num_actions))
    for t in range(60):
        state, out = env.step(state, zeros)
        assert bool(torch.isfinite(out.obs).all()), f"non-finite obs @ {t}"
        assert bool(torch.isfinite(out.rew).all())
    # standing robot must not wander: base stays near its origin
    drift = float((state.robot.q[:, :2] - state.env_origins[:, :2]).abs().max())
    assert drift < 1.0, f"zero-action drift {drift} m"
    assert int(state.common_step) == 60


def test_rollout_takes_a_single_reward_env():
    """A legged step output has no `extras` and reports `terrain_level`:
    the rollout collects it, with zeros for the arm supervision data."""
    env, spec = make_env("go1", num_envs=6, seed=1, device="cpu")
    model = MlpActorCritic(num_obs=env.num_obs, num_actions=12,
                           actor_hidden_dims=(16,), critic_hidden_dims=(16,))
    rollout = Rollout(env, model, spec.ppo_cfg, num_steps=3)
    keys = rollout.stat_keys()
    assert "terrain_level" in keys and "term_roll" not in keys
    assert any(k.startswith("metric_level_") for k in keys)
    assert rollout.arm_default is None and not rollout.has_counter
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    state, obs, traj, stats, nres = rollout.collect(state, obs, 1.0, gen,
                                                    False)
    assert traj.obs.shape == (3, 6, 235) and traj.rewards.shape == (3, 6, 1)
    assert traj.log_probs.shape == (3, 6, 1) and traj.values.shape == (3, 6, 1)
    assert traj.target_arm_torques.shape == (3, 6, 6)
    assert not traj.target_arm_torques.any()
    assert set(stats) == set(keys)
    # three steps' mean curriculum level
    want = 3 * float(state.terrain_levels.float().mean())
    assert float(stats["terrain_level"]) == pytest.approx(want, rel=1e-5)


def test_runner_trains_a_legged_task(tmp_path):
    """make_runner builds an OnPolicyRunner with the MLP policy for a
    single-head task; two iterations log Episode/terrain_level as a
    per-step mean, move every parameter and survive a checkpoint."""
    log_dir = str(tmp_path / "run")
    env, runner, spec = make_runner("go1", num_envs=8, seed=2,
                                    log_dir=log_dir, device="cpu")
    assert isinstance(runner, OnPolicyRunner)
    assert isinstance(runner.model, MlpActorCritic)
    assert [l.out_features for l in runner.model.actor_layers] == [
        512, 256, 128, 12]
    assert runner.ppo_state.hist_opt is None
    start = {k: v.clone() for k, v in runner.model.state_dict().items()}
    runner.learn(2, log_every=1)
    runner.close()
    for k, v in runner.model.state_dict().items():
        assert torch.isfinite(v).all() and not torch.equal(v, start[k]), k
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    for r in rows:
        assert 0.0 <= r["Episode/terrain_level"] <= 9.0
        assert "Episode/metric_level_stairs_up" in r
        assert r["Train/mean_arm_reward"] == 0.0
        assert r["Loss/priv_reg_loss"] == 0.0
        assert all(np.isfinite(v) for v in r.values())
    level = float(runner.env_state.terrain_levels.float().mean())
    assert rows[1]["Episode/terrain_level"] == pytest.approx(level, abs=1.0)

    _, other, _ = make_runner("go1", num_envs=4, seed=5, device="cpu")
    other.load(os.path.join(log_dir, "model_2"))
    for a, b in zip(runner.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert (other.it, other.ppo_state.counter) == (2, 2)
    obs = torch.zeros((4, 235))
    assert other.get_inference_policy()(obs).shape == (4, 12)


def test_make_runner_selects_the_recurrent_runner():
    env, runner, spec = make_runner("go1_flat_lstm", num_envs=4, seed=1,
                                    device="cpu")
    assert isinstance(runner, RecurrentRunner)
    assert spec.policy_class_name == "ActorCriticRecurrent"
    # legged_gym's published recurrent policy (LeggedRobotCfgPPO.policy):
    # LSTM 512, MLP 512-256-128 in both heads, elu, std 1.0
    assert runner.model.rnn_type == "lstm"
    assert runner.model.rnn_hidden_size == 512
    assert runner.model.memory_a.wh.in_features == 512
    assert [l.out_features for l in runner.model.actor_layers] == [
        512, 256, 128, 12]
    assert [l.out_features for l in runner.model.critic_layers] == [
        512, 256, 128, 1]
    assert torch.equal(runner.model.std, torch.ones(12))
    assert runner.model.act is torch.nn.functional.elu
    # the recurrent runner does not randomise the episode clocks
    assert not runner.env_state.episode_length.any()
    assert ppo.PPOConfig(**dataclasses.asdict(spec.ppo_cfg)).num_heads == 1


def test_a_direct_recurrent_runner_keeps_the_jax_twins_widths():
    """RecurrentRunner built without the registry's widths trains the JAX
    package's RecurrentRunner policy: an LSTM of 64, one layer of 64."""
    env, spec = make_env("go1_flat_lstm", num_envs=4, seed=1, device="cpu")
    runner = RecurrentRunner(env, spec.ppo_cfg, seed=1)
    assert runner.model.rnn_hidden_size == 64
    assert [l.out_features for l in runner.model.actor_layers] == [64, 12]
    assert [l.out_features for l in runner.model.critic_layers] == [64, 1]


@pytest.mark.parametrize("flag,msg", [
    ("--droop_comp", "--droop_comp is only available for the widowGo1 task "
                     "family"),
    ("--spawn_relative", "--spawn_relative is only available for the "
                         "widowGo1 task family")])
def test_train_cli_refuses_widow_flags_on_a_legged_env(flag, msg, tmp_path):
    with pytest.raises(SystemExit) as e:
        train.main(["--task", "go1_flat", "--cpu", "--num_envs", "4",
                    "--max_iterations", "1", "--log_root", str(tmp_path),
                    flag])
    assert msg in str(e.value)


def test_train_cli_runs_a_legged_task_and_needs_a_card(tmp_path):
    runner = train.main(["--task", "cassie", "--cpu", "--num_envs", "4",
                         "--max_iterations", "1", "--log_every", "1",
                         "--log_root", str(tmp_path), "--exptid", "t"])
    assert runner.it == 1
    assert os.path.exists(tmp_path / "rough_cassie" / "t" / "model_1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--task", "go1_flat_lstm", "--num_envs", "4",
                        "--max_iterations", "1", "--log_root", str(tmp_path)])
    with pytest.raises(SystemExit, match="unknown task"):
        train.main(["--task", "go2", "--cpu"])
