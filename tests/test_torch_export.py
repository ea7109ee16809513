"""The port's deployment tools (runner/export.py, runner/play.py,
runner/visualize.py, utils/logger.Logger) on the CPU: the twin of
tests/test_export.py (both exported programs against the live model at a
batch other than the export batch, play --use_jit end to end with the npz
and the Logger figure), the refusal of another device's artifact,
stochastic play, and the figures of Logger and visualize.render. The
programs against the JAX package's model are in
tests/test_torch_export_jax.py, the npz layout against the JAX play.py's
in tests/test_torch_play.py."""

import os

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.runner import export as export_mod
from dwbc_tpu_torch.runner import play as play_mod
from dwbc_tpu_torch.runner import visualize
from dwbc_tpu_torch.utils.logger import Logger
from dwbc_tpu_torch.utils.task_registry import make_runner


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def go1_export(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    env, runner, _ = make_runner("go1_flat", num_envs=2, device="cpu")
    ckpt = str(tmp / "ckpt")
    runner.save(ckpt)
    out_dir = str(tmp / "export")
    export_mod.main(["--task", "go1_flat", "--checkpoint", ckpt,
                     "--out_dir", out_dir, "--cpu"])
    return ckpt, out_dir, env, runner


def test_export_roundtrip_matches_live_model(go1_export):
    """Both programs == the live model at batches 3 and 1 (the export
    batch is 2: the batch dimension did not specialise)."""
    _, out_dir, env, runner = go1_export
    assert sorted(os.listdir(out_dir)) == ["actor_critic.pt", "export.json",
                                           "hist_encoder.pt2", "policy.pt2"]
    policy = export_mod.load_artifact(out_dir, "policy", "cpu")
    hist = export_mod.load_artifact(out_dir, "hist_encoder", "cpu")
    for b in (3, 1):
        obs = torch.as_tensor(np.random.default_rng(b).normal(
            size=(b, env.num_obs)).astype(np.float32))
        with torch.no_grad():
            torch.testing.assert_close(policy(obs),
                                       runner.model.act_mean(obs, True),
                                       rtol=0, atol=1e-5)
            torch.testing.assert_close(hist(obs), runner.model.hist_latent(obs),
                                       rtol=0, atol=1e-5)
    weights = torch.load(os.path.join(out_dir, "actor_critic.pt"),
                         weights_only=True)
    for k, v in runner.model.state_dict().items():
        assert torch.equal(weights[k], v)


def test_artifact_refuses_another_device(go1_export, tmp_path):
    """A program captured on one device type is not run on another."""
    import json
    import shutil
    _, out_dir, _, _ = go1_export
    card = str(tmp_path / "card")
    shutil.copytree(out_dir, card)
    with open(os.path.join(card, "export.json"), "w") as f:
        json.dump({"device": "cuda", "num_obs": 48}, f)
    with pytest.raises(RuntimeError, match="exported on cuda"):
        export_mod.load_artifact(card, "policy", "cpu")


def test_play_use_jit_end_to_end(go1_export, tmp_path):
    """play --use_jit drives the env with the loaded program and writes
    the npz and the Logger figure; visualize renders the npz."""
    ckpt, out_dir, _, _ = go1_export
    out = str(tmp_path / "traj.npz")
    summary = play_mod.main(["--task", "go1_flat", "--num_envs", "2",
                             "--steps", "5", "--checkpoint", ckpt,
                             "--use_jit", out_dir, "--out", out, "--cpu"])
    assert summary["use_jit_max_abs_err"] < 1e-5
    assert os.path.exists(str(tmp_path / "traj_states.png"))
    data = np.load(out)
    assert data["q"].shape[0] == 5
    png = visualize.render(out, 1, str(tmp_path / "viz.png"))
    assert os.path.getsize(png) > 10_000


def test_stochastic_play_samples(tmp_path):
    """--stochastic passes a seeded generator: the played actions differ
    from the deterministic ones, and repeat from the seed."""
    runs = [play_mod.play("go1_flat", num_envs=2, steps=3, stochastic=s,
                          out=str(tmp_path / f"t{i}.npz"), device="cpu",
                          plot=False)
            for i, s in enumerate((False, True, True))]
    q = [np.load(r["npz"])["q"] for r in runs]
    assert not np.allclose(q[0], q[1])
    np.testing.assert_array_equal(q[1], q[2])
    # without a generator the stochastic policy returns the mean, as the
    # JAX package's does without a key
    _, runner, _ = make_runner("go1_flat", num_envs=2, device="cpu")
    obs = torch.ones((2, 48))
    torch.testing.assert_close(runner.get_inference_policy(True)(obs),
                               runner.get_inference_policy(False)(obs))


def test_logger_takes_tensors_and_plots(tmp_path, capsys):
    logger = Logger(0.02)
    for t in range(4):
        logger.log_states({"base_vel_x": torch.tensor(0.1 * t),
                           "command_x": np.float32(0.5), "dof_pos": 0.2})
    logger.log_rewards({"tracking": torch.tensor(2.0)}, 3)
    assert logger.state_log["base_vel_x"][2] == pytest.approx(0.2)
    png = logger.plot_states(str(tmp_path / "states.png"))
    assert os.path.getsize(png) > 10_000
    logger.print_rewards()
    assert "tracking: 2.0000" in capsys.readouterr().out
