"""The port's OnPolicyRunner, make_runner and the train CLI on the CPU.

The two packages draw different random numbers, so the runner is held to
the JAX runner's behaviour rather than to its numbers: the keys of a
metrics.jsonl line (a literal list taken from the JAX runner's `_log`),
which parameters each kind of iteration may touch, the schedule counters,
and the checkpoint round trip. 16 envs, 40 steps.
"""

import json
import os
import sys

import pytest
import torch

from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.runner import train
from dwbc_tpu_torch.utils import task_registry

# the keys the JAX runner logs for the widowGo1 family, besides Loss/*,
# Episode/rew_*, Episode/metric_*
BASE_KEYS = [
    "it", "Perf/total_fps", "Perf/collection time", "Perf/learning_time",
    "Loss/learning_rate", "Policy/leg_mean_noise_std",
    "Policy/arm_mean_noise_std", "Train/mean_reward", "Train/mean_arm_reward",
    "Train/mean_episode_length", "Train/dones",
    "Episode/term_roll", "Episode/term_pitch", "Episode/term_z",
    "Episode/term_timeout", "Episode/term_bad",
    "Episode/step_base_height_rel", "Episode/step_z_margin_low",
    "Episode/step_vel_x", "Episode/step_cmd_x",
]
# the iteration's span seconds and host synchronisations (utils/spans)
SPAN_KEYS = ["Perf/host_syncs"] + ["Perf/span/" + k for k in (
    "runner.collect", "rollout.policy", "env.physics", "env.post", "sim.fk",
    "sim.contact", "sim.aba", "sim.integrate", "runner.learn")]
DAGGER_SPAN_KEYS = ["Perf/span/ppo.dagger_minibatch"]
PPO_SPAN_KEYS = ["Perf/span/ppo.gae", "Perf/span/ppo.minibatch"]
DAGGER_LOSS_KEYS = ["Loss/hist_latent_loss"]
PPO_LOSS_KEYS = [
    "Loss/value_loss", "Loss/surrogate_loss", "Loss/priv_reg_loss",
    "Loss/arm_torques_loss", "Loss/mixing_ratio", "Loss/priv_reg_coef",
    "Loss/torque_supervision_weight", "Loss/hist_latent_loss",
    "Loss/adv_leg_abs", "Loss/adv_arm_abs", "Loss/adv_leg_mixed_share",
]


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
    """The tensors here are tiny: beside other test workers on the same
    machine, one thread per core only oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params_of(runner):
    return {k: v.clone() for k, v in runner.model.state_dict().items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A runner after learn(2): iteration 0 is the DAgger phase, iteration
    1 the PPO update. Snapshots of the parameters around each."""
    log_dir = str(tmp_path_factory.mktemp("run"))
    env, runner, spec = task_registry.make_runner(
        "widowGo1", num_envs=16, seed=1, log_dir=log_dir, device="cpu")
    snaps = [params_of(runner)]
    runner.learn(1, log_every=1)
    snaps.append(params_of(runner))
    runner.learn(1, log_every=1)
    snaps.append(params_of(runner))
    return env, runner, spec, log_dir, snaps


def test_metrics_jsonl_has_the_jax_runners_keys(trained):
    env, runner, _, log_dir, _ = trained
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    assert len(lines) == 2 and [l["it"] for l in lines] == [0, 1]
    episode = (["Episode/rew_" + k
                for k in env.reward_names + env.arm_reward_names]
               + ["Episode/metric_" + k for k in env.metric_names])
    assert set(lines[0]) == set(BASE_KEYS + episode + DAGGER_LOSS_KEYS
                                + SPAN_KEYS + DAGGER_SPAN_KEYS)
    assert set(lines[1]) == set(BASE_KEYS + episode + PPO_LOSS_KEYS
                                + SPAN_KEYS + PPO_SPAN_KEYS)
    for line in lines:
        assert line["Perf/total_fps"] > 0
        for k, v in line.items():
            assert isinstance(v, (int, float)) and v == v, k
    assert lines[1]["Loss/learning_rate"] == pytest.approx(2e-4)
    assert lines[1]["Policy/leg_mean_noise_std"] == pytest.approx(
        float(runner.model.std.detach()[:12].mean()), rel=1e-6)


def test_iteration_0_touches_only_the_history_encoder(trained):
    _, runner, _, _, snaps = trained
    enc_moved = 0
    for k in snaps[0]:
        if "history_encoder" in k:
            enc_moved += int(not torch.equal(snaps[0][k], snaps[1][k]))
        else:
            assert torch.equal(snaps[0][k], snaps[1][k]), k
    assert enc_moved == 8
    # iteration 1 is the PPO update: it leaves the history encoder alone
    # and moves the rest
    for k in snaps[1]:
        same = torch.equal(snaps[1][k], snaps[2][k])
        assert same == ("history_encoder" in k), k
    assert runner.ppo_state.counter == 2 and runner.it == 2
    floor = torch.tensor(runner.cfg.min_policy_std)
    assert bool((runner.model.std >= floor).all())
    assert runner.last_traj.obs.shape == (40, 16, 860)
    assert runner.tot_timesteps == 2 * 40 * 16


def test_save_load_round_trip(trained, tmp_path):
    _, runner, _, log_dir, _ = trained
    assert os.path.isfile(os.path.join(log_dir, "model_2"))   # learn saved
    (tmp_path / "ckpt").mkdir()
    path = str(tmp_path / "ckpt" / "model_7")
    runner.save(path)
    _, other, _ = task_registry.make_runner("widowGo1", num_envs=4, seed=5,
                                            device="cpu")
    assert not torch.equal(other.model.std, runner.model.std) or not all(
        torch.equal(a, b) for a, b in zip(other.model.parameters(),
                                          runner.model.parameters()))
    other.load(path)
    for (k, a), b in zip(runner.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert other.it == 2 and other.ppo_state.counter == 2
    assert other.ppo_state.learning_rate == runner.ppo_state.learning_rate
    for opt, ref in ((other.ppo_state.opt, runner.ppo_state.opt),
                     (other.ppo_state.hist_opt, runner.ppo_state.hist_opt)):
        for p, q in zip(opt.param_groups[0]["params"],
                        ref.param_groups[0]["params"]):
            assert float(opt.state[p]["step"]) == float(ref.state[q]["step"])
            assert torch.equal(opt.state[p]["exp_avg"],
                               ref.state[q]["exp_avg"])
            assert torch.equal(opt.state[p]["exp_avg_sq"],
                               ref.state[q]["exp_avg_sq"])
    # load_optimizer=False keeps the optimizers as they are
    _, fresh, _ = task_registry.make_runner("widowGo1", num_envs=4, seed=6,
                                            device="cpu")
    fresh.load(path, load_optimizer=False)
    assert torch.equal(fresh.model.std, runner.model.std)
    assert fresh.ppo_state.counter == 2
    assert len(fresh.ppo_state.opt.state) == 0
    assert len(fresh.ppo_state.hist_opt.state) == 0
    # the latest-checkpoint search reads the iteration from the name
    exp_dir = os.path.dirname(log_dir)
    assert os.path.realpath(train._latest_checkpoint(exp_dir)) == (
        os.path.realpath(os.path.join(log_dir, "model_2")))


def test_force_terminal_schedules_and_policy(trained):
    _, runner, _, _, _ = trained
    _, other, _ = task_registry.make_runner("widowGo1", num_envs=4, seed=2,
                                            device="cpu")
    other.force_terminal_schedules()
    assert other.it >= 1_000_000 and other.ppo_state.counter >= 1_000_000
    cfg = other.cfg
    assert ppo.mixing_ratio(cfg, other.ppo_state.counter) == 1.0
    assert ppo.priv_reg_coef(cfg, other.ppo_state.counter) == pytest.approx(
        cfg.priv_reg_coef_schedule[1])
    policy = runner.get_inference_policy()
    act = policy(runner.obs)
    assert act.shape == (16, 18) and not act.requires_grad
    torch.testing.assert_close(act, runner.model.act_mean(runner.obs, True))
    noisy = runner.get_inference_policy(stochastic=True)(
        runner.obs, torch.Generator().manual_seed(0))
    assert not torch.equal(noisy, act)


def test_make_runner_overrides_and_env_setup():
    seen = []

    def env_setup(env):
        env.spawn_relative = True
        seen.append(env)

    env, runner, spec = task_registry.make_runner(
        "widowGo1_flat", num_envs=4, device="cpu",
        ppo_overrides=dict(mixing_schedule=(1.0, 0.0, 1.0)),
        env_setup=env_setup)
    assert seen == [env] and runner.cfg.mixing_schedule == (1.0, 0.0, 1.0)
    assert spec.ppo_cfg is runner.cfg
    # the flag was set before the runner's initial reset: ground + 0.40
    torch.testing.assert_close(runner.env_state.robot.q[:, 2],
                               torch.full((4,), 0.40))
    # the episode clocks start desynchronised
    assert runner.env_state.episode_length.dtype == torch.int32
    # a single-head config gets the MLP policy (it raised before that
    # policy was ported)
    from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
    from dwbc_tpu_torch.rl.runner import OnPolicyRunner
    legged, lspec = task_registry.make_env("go1_flat", 4, device="cpu")
    assert lspec.ppo_cfg.num_heads == 1
    assert isinstance(OnPolicyRunner(legged, lspec.ppo_cfg).model,
                      MlpActorCritic)


def test_adaptive_runner_trains_with_torque_supervision():
    _, runner, _ = task_registry.make_runner(
        "widowGo1_adaptive", num_envs=8, device="cpu",
        ppo_overrides=dict(dagger_update_freq=1000,
                           torque_supervision_schedule=(1.0, 1000.0, 1000.0)))
    runner.learn(2, log_every=100)     # iteration 1 is a PPO update
    traj = runner.last_traj
    assert traj.actions.shape == (40, 8, 24)
    assert torch.isfinite(traj.target_arm_torques).all()
    assert traj.target_arm_torques.abs().max() > 0
    for p in runner.model.parameters():
        assert torch.isfinite(p).all()
    assert runner.model.std.shape == (24,)


def test_train_cli_in_process(tmp_path):
    runner = train.main(["--task", "widowGo1", "--num_envs", "16",
                         "--max_iterations", "2", "--cpu", "--log_root",
                         str(tmp_path), "--exptid", "cli", "--log_every", "1"])
    run = tmp_path / "rough_widowGo1" / "cli"
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2
    assert (run / "model_2").is_file()
    assert (run / "src" / "dwbc_tpu_torch" / "rl" / "ppo.py").is_file()
    assert (run / "src" / "dwbc_tpu_torch" / "csrc" / "contact_law.cu").is_file()
    assert runner.it == 2 and runner.device.type == "cpu"
    # resume, with the schedules restarted
    again = train.main(["--task", "widowGo1", "--num_envs", "16",
                        "--max_iterations", "0", "--cpu", "--log_root",
                        str(tmp_path), "--exptid", "cli2", "--resume",
                        "--reset_schedules", "--reset_std"])
    assert again.it == 0 and again.ppo_state.counter == 0
    assert again.env.terminal_reward_scales
    for a, b in zip(again.model.actor.parameters(),
                    runner.model.actor.parameters()):
        assert torch.equal(a, b)
    assert again.model.std.tolist() == pytest.approx(list(again.model.init_std))


def test_train_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--task", "widowGo1", "--num_envs", "16",
                    "--max_iterations", "2", "--log_root", str(tmp_path)])
    with pytest.raises(SystemExit):
        train.main(["--task", "no_such_task", "--cpu"])


def test_train_cli_refuses_commit_curves(tmp_path):
    """The curve-commit tool is not part of the port: the flag parses, and
    a value above 0 is refused before anything is built."""
    with pytest.raises(SystemExit, match="not ported"):
        train.main(["--task", "widowGo1", "--cpu", "--commit_curves", "60",
                    "--log_root", str(tmp_path)])
    assert not os.listdir(tmp_path)
