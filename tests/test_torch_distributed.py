"""Data-parallel training over torch.distributed on the CPU (gloo).

Twins of tests/test_distributed.py (the helpers in one process), of
tests/test_multihost.py (two processes, each building only its shard of
go1_flat, `OnPolicyRunner.learn(2)`, parameters bitwise equal across the
ranks, rank 0 alone logging and saving) and of
test_recurrent_sharded_update_matches_single_device (one epoch, one
minibatch: the two ranks' update equals one process's over the whole
batch, rtol 1e-3 / atol 1e-5, for `ppo.update` and `RecurrentPPO.update`).
Against the JAX package: its `ppo.update` under shard_map on a 2-device
CPU mesh and the port's on two ranks, fed the same per-rank permutations,
every parameter within rtol 1e-4 / atol 1e-5 and the learning rate
exact. And the command curriculum decides on both ranks' counts.

The two ranks run once, as subprocesses (gloo over a FileStore under the
test's tmp dir: no TCP port to collide between test workers), and write
what the tests read.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu.models import mlp_actor_critic as jmlp
from dwbc_tpu.rl import ppo as jppo
from dwbc_tpu_torch import interop
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
from dwbc_tpu_torch.parallel import distributed as dist
from dwbc_tpu_torch.parallel import mesh
from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.rl.recurrent import RecurrentPPO, RecurrentTransition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N = 4, 8                       # the update checks' batch; N splits 4 + 4
DIMS = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(24, 16))
# the legged family's settings (adaptive rate: the KL is averaged)
KW = dict(num_heads=1, use_dagger=False, use_roa=False, entropy_coef=0.01,
          learning_rate=5e-4, schedule="adaptive", desired_kl=0.01,
          min_policy_std=(0.0,) * 12)
ONE = dict(KW, num_learning_epochs=1, num_mini_batches=1)
TWO = dict(KW, num_learning_epochs=2, num_mini_batches=2)


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert dist.is_main() and dist.rank() == 0 and dist.world_size() == 1


def test_initialize_raises_without_a_card(monkeypatch):
    """Under a launcher a rank asks for cuda:LOCAL_RANK and raises without
    one instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda"):
        dist.initialize()
    assert not torch.distributed.is_initialized()


def test_host_env_count(monkeypatch):
    assert dist.host_env_count(4096) == 4096
    monkeypatch.setattr(dist, "world_size", lambda: 3)
    assert dist.host_env_count(4098) == 1366
    with pytest.raises(ValueError, match="not divisible by 3"):
        dist.host_env_count(4096)


def test_single_process_collectives_change_nothing():
    t = torch.arange(4.0)
    dist.all_reduce_sum([t])
    dist.all_reduce_mean([t])
    mesh.replicate([t])
    assert torch.equal(t, torch.arange(4.0))
    assert mesh.env_slice(8) == slice(0, 8)


_WORKER = r"""
import dataclasses, os, sys
# TensorBoard's writer imports TensorFlow where it is installed, which
# takes longer than this whole job; without it TensorBoard uses its own
# stub and writes the same event files
sys.modules["tensorflow"] = None
import numpy as np
import torch
rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
torch.set_num_threads(1)
from dwbc_tpu_torch.parallel import distributed as dist
from dwbc_tpu_torch.envs import legged_config as lc
from dwbc_tpu_torch.envs.legged_robot import LeggedRobotEnv
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.rl.recurrent import RecurrentPPO, RecurrentTransition
from dwbc_tpu_torch.rl.runner import OnPolicyRunner

dev = dist.initialize(device="cpu", init_method="file://" + store)
assert dev.type == "cpu" and (dist.rank(), dist.world_size()) == (rank, world)
data = dict(np.load(os.path.join(tmp, "jobs.npz")))
out = {}

# 1. go1_flat, each rank building only its shard, two iterations
cfg = lc.go1_flat()
cfg = dataclasses.replace(cfg, commands=dataclasses.replace(
    cfg.commands, curriculum=True, max_curriculum=2.0))
env = LeggedRobotEnv(cfg, num_envs=dist.host_env_count(8), seed=3,
                     device="cpu")
assert dist.active() and env.num_envs == 4
pcfg = ppo.PPOConfig(**dict(eval(str(data["two"]))))
runner = OnPolicyRunner(env, pcfg, num_steps_per_env=2, seed=1,
                        log_dir=os.path.join(tmp, "run"))
assert runner.num_envs_global == 8 and runner.is_main == (rank == 0)
runner.learn(2, log_every=1)
# one more log line from crafted per-rank numbers: the job's sums and means
stats = {"reward_sum": torch.tensor(10.0 * (rank + 1)),
         "arm_reward_sum": torch.tensor(0.0),
         "len_sum": torch.tensor(100.0 * (rank + 1)),
         "terrain_level": torch.tensor(float(rank + 1)),
         "rew_tracking_lin_vel": torch.tensor(4.0 * (rank + 1))}
runner._log(99, {"value_loss": torch.tensor(float(rank + 1))}, stats,
            torch.tensor(rank + 1), 1.0, 1.0)
runner.close()
out["params"] = torch.cat([p.detach().reshape(-1)
                           for p in runner.model.parameters()]).numpy()
out["lr"] = np.float64(runner.ppo_state.learning_rate)
out["obs"] = runner.obs.numpy()

# 2. the command curriculum: rank 0's resetting envs track well, rank 1's
# not at all; their mean passes the threshold, so both ranks widen
state = runner.env_state
n = env.num_envs
thr = 0.8 * env.reward_scales["tracking_lin_vel"] * env.max_episode_length
sums = dict(state.episode_sums)
sums["tracking_lin_vel"] = torch.full((n,), 3.0 * thr if rank == 0 else 0.0)
state = dataclasses.replace(state, episode_sums=sums,
                            common_step=torch.zeros_like(state.common_step))
out["vx_before"] = state.command_lin_vel_x.numpy()
state = env._reset_envs(state.generator, state,
                        torch.ones((n,), dtype=torch.bool))
out["vx_after"] = state.command_lin_vel_x.numpy()

# the per-family terrain levels a step logs: a small grid with the
# terrain curriculum, rank 0's envs at level 0 and rank 1's at level 1,
# every env timing out; each family's job mean is 0.5 on both ranks
rcfg = lc.go1_rough()
rcfg = dataclasses.replace(rcfg, terrain=dataclasses.replace(
    rcfg.terrain, num_rows=2, num_cols=4, border_size=1.0,
    max_init_terrain_level=1))
renv = LeggedRobotEnv(rcfg, num_envs=4, seed=3, device="cpu")
rs, _ = renv.reset(torch.Generator().manual_seed(rank))
rs = dataclasses.replace(
    rs, terrain_levels=torch.full((4,), rank, dtype=torch.long),
    episode_length=torch.full((4,), int(renv.max_episode_length) + 1,
                              dtype=torch.int32))
rs, rout = renv.step(rs, torch.zeros((4, 12)))
out["fam_nres"] = rout.num_resets.numpy()
out["fam_levels"] = np.array([float(rout.episode_stats["metric_" + k])
                              for k in renv.metric_names
                              if k.startswith("level_")])

# 3. one-epoch one-minibatch updates on this rank's half of the batch
half = slice(rank * 4, rank * 4 + 4)
def traj(prefix, cls):
    return cls(*(torch.as_tensor(data[f"{prefix}.{f}"][:, half])
                 for f in cls._fields))

one = ppo.PPOConfig(**dict(eval(str(data["one"]))))
model = MlpActorCritic(48, 12, **dict(eval(str(data["dims"]))))
model.load_state_dict(torch.load(os.path.join(tmp, "mlp.pt")))
state = ppo.PPOState(one, model)
tr = traj("ff", ppo.Transition)
ret, adv = ppo.compute_gae(one, tr, torch.as_tensor(data["ff.last"][half]))
ppo.update(one, state, tr, ret, adv, perm=torch.arange(16))
out["ff_params"] = torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()]).numpy()

rmodel = ActorCriticRecurrent(num_obs=48, num_actions=12, rnn_hidden_size=16,
                              actor_hidden_dims=(16,), critic_hidden_dims=(16,))
rmodel.load_state_dict(torch.load(os.path.join(tmp, "rnn.pt")))
rstate = ppo.PPOState(one, rmodel)
h0 = tuple(tuple(torch.as_tensor(data[f"rnn.h{i}{j}"][half])
                 for j in range(2)) for i in range(2))
RecurrentPPO(None, rmodel, one, num_steps=4).update(
    rstate, traj("rnn", RecurrentTransition), h0,
    torch.as_tensor(data["rnn.last"][half]), perm=torch.arange(4))
out["rnn_params"] = torch.cat([p.detach().reshape(-1)
                               for p in rmodel.parameters()]).numpy()

# 4. the JAX-fed update: two epochs x two minibatches, JAX's permutation
two = ppo.PPOConfig(**dict(eval(str(data["two"]))))
model = MlpActorCritic(48, 12, **dict(eval(str(data["dims"]))))
model.load_state_dict(torch.load(os.path.join(tmp, "jax_mlp.pt")))
state = ppo.PPOState(two, model)
tr = traj("jx", ppo.Transition)
ret, adv = ppo.compute_gae(two, tr, torch.as_tensor(data["jx.last"][half]))
metrics = ppo.update(two, state, tr, ret, adv,
                     perm=torch.as_tensor(data[f"jx.perm{rank}"]))
out["jx_adv"] = adv.numpy()
for name, p in model.state_dict().items():
    out["jx." + name] = p.numpy()
out["jx_lr"] = np.float64(state.learning_rate)
out["jx_value_loss"] = metrics["value_loss"].numpy()
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
dist.shutdown()
print("RANK_OK", rank, flush=True)
"""


def _traj(rng, model_mean, std, t, n, num_obs=48, recurrent=False):
    f32 = np.float32
    obs = rng.normal(size=(t, n, num_obs)).astype(f32)
    mean = model_mean(obs)
    actions = (mean + 0.3 * std * rng.normal(size=mean.shape)).astype(f32)
    logp = (-0.5 * ((actions - mean) / std) ** 2 - np.log(std)
            - 0.5 * np.log(2 * np.pi)).sum(-1, keepdims=True).astype(f32)
    dones = rng.random((t, n)) < 0.2
    d = dict(obs=obs, actions=actions,
             rewards=rng.normal(size=(t, n, 1)).astype(f32), dones=dones,
             time_outs=dones & (rng.random((t, n)) < 0.5),
             values=rng.normal(size=(t, n, 1)).astype(f32), log_probs=logp,
             mu=(mean + 0.2 * rng.normal(size=mean.shape)).astype(f32),
             sigma=np.broadcast_to(std, mean.shape).astype(f32).copy())
    if recurrent:
        d["dones_prev"] = np.concatenate([np.zeros((1, n), bool), dones[:-1]])
    else:
        z6 = np.zeros((t, n, 6), f32)
        d.update(target_arm_torques=z6, current_arm_dof_pos=z6,
                 current_arm_dof_vel=z6)
    return d


def _jax_sharded(params, traj_np, last, key):
    """The JAX package's update under shard_map over 2 CPU devices, GAE
    and the advantage normalisation outside it, as its runner does."""
    from jax.sharding import Mesh, PartitionSpec as P
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    jcfg = jppo.PPOConfig(**TWO)
    jmodel = jmlp.MlpActorCritic(num_obs=48, num_actions=12, **DIMS)
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj_np.items()})
    ret, adv = jppo.compute_gae(jcfg, jtraj, jnp.asarray(last))
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    batch = P(None, "data")
    fn = shard_map(
        lambda st, tr, rt, ad, k: jppo.update(jcfg, jmodel, st, tr, rt, ad, k,
                                              axis_name="data"),
        mesh=jmesh, in_specs=(P(),) + (batch,) * 3 + (P(),),
        out_specs=(P(), P()), check_vma=False)
    state, metrics = jax.jit(fn)(jppo.init_state(jcfg, params), jtraj, ret,
                                 adv, key)
    return state, metrics, np.asarray(adv)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    jobs = {"one": repr(ONE), "two": repr(TWO), "dims": repr(DIMS)}
    # one-minibatch updates: a feedforward and a recurrent model
    mlp = MlpActorCritic(48, 12, **DIMS)
    torch.save(mlp.state_dict(), tmp / "mlp.pt")
    with torch.no_grad():
        ff = _traj(rng, lambda o: mlp.act_mean(torch.as_tensor(o)).numpy(),
                   mlp.std.numpy(), T, N)
    jobs.update({"ff." + k: v for k, v in ff.items()})
    jobs["ff.last"] = rng.normal(size=(N, 1)).astype(np.float32)
    rnn = ActorCriticRecurrent(num_obs=48, num_actions=12, rnn_hidden_size=16,
                               actor_hidden_dims=(16,),
                               critic_hidden_dims=(16,))
    torch.save(rnn.state_dict(), tmp / "rnn.pt")
    h0 = [[rng.normal(size=(N, 16)).astype(np.float32) for _ in range(2)]
          for _ in range(2)]
    with torch.no_grad():
        def rnn_mean(o):
            dprev = torch.zeros(o.shape[:2], dtype=torch.bool)
            h = tuple(tuple(torch.as_tensor(x) for x in c) for c in h0)
            return rnn.unroll(h, torch.as_tensor(o), dprev)[1][0].numpy()
        rt = _traj(rng, rnn_mean, rnn.std.numpy(), T, N, recurrent=True)
    jobs.update({"rnn." + k: v for k, v in rt.items()})
    jobs.update({f"rnn.h{i}{j}": h0[i][j] for i in range(2) for j in range(2)})
    jobs["rnn.last"] = rng.normal(size=(N, 1)).astype(np.float32)
    # the JAX-fed update: flax parameters carried into the port model
    jmodel = jmlp.MlpActorCritic(num_obs=48, num_actions=12, **DIMS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((2, 48)))
    jx_model = MlpActorCritic(48, 12, **DIMS)
    interop.mlp_actor_critic_from_flax(jax.tree.map(np.asarray, params),
                                       jx_model)
    torch.save(jx_model.state_dict(), tmp / "jax_mlp.pt")
    jx = _traj(rng, lambda o: np.asarray(jax.jit(
        lambda p, x: jmodel.apply(p, x, method="act_mean"))(
            params, jnp.asarray(o))),
        np.asarray(params["params"]["std"]), T, N)
    jobs.update({"jx." + k: v for k, v in jx.items()})
    jobs["jx.last"] = rng.normal(size=(N, 1)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    for i in range(2):   # what each device of the shard_map draws
        jobs[f"jx.perm{i}"] = np.asarray(jax.random.permutation(
            jax.random.fold_in(key, i), T * N // 2))
    np.savez(tmp / "jobs.npz", **jobs)

    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               str(tmp / "store"), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(2)]
    # the JAX side meanwhile
    jstate, jmetrics, jadv = _jax_sharded(params, jx, jobs["jx.last"], key)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out[-4000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return dict(tmp=tmp, ranks=ranks, jobs=jobs, mlp=mlp, rnn=rnn, h0=h0,
                jstate=jstate, jmetrics=jmetrics, jadv=jadv, jx_model=jx_model)


def test_two_rank_training_keeps_replicas_equal(two_ranks):
    """Twin of tests/test_multihost.py: each rank stepped its own envs,
    and after two iterations the parameters and learning rate are
    bitwise equal; rank 0 alone wrote metrics.jsonl and the checkpoint."""
    r0, r1 = two_ranks["ranks"]
    assert np.array_equal(r0["params"], r1["params"])
    assert r0["lr"] == r1["lr"]
    assert not np.array_equal(r0["obs"], r1["obs"])
    run = two_ranks["tmp"] / "run"
    files = os.listdir(run)
    assert [f for f in files if f.startswith("model_")] == ["model_2"]
    assert len([f for f in files if f.startswith("events.")]) <= 1
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3


def test_logged_numbers_are_the_jobs(two_ranks):
    """Rank 0 logs what one process over both ranks' envs would: sums
    summed (rewards, lengths, resets), means averaged (losses, the
    per-step terrain level). The per-family terrain levels an env step
    logs carry the job's family means (0.5 here, where the ranks' own
    are 0 and 1), scaled by the rank's resets."""
    import json
    line = json.loads((two_ranks["tmp"] / "run" / "metrics.jsonl")
                      .read_text().splitlines()[-1])
    assert line["it"] == 99
    assert line["Train/mean_reward"] == pytest.approx(30.0 / 3)
    assert line["Train/mean_episode_length"] == pytest.approx(300.0 / 3)
    assert line["Episode/rew_tracking_lin_vel"] == pytest.approx(12.0 / 3)
    assert line["Train/dones"] == pytest.approx(3 / 8 / 2)
    assert line["Episode/terrain_level"] == pytest.approx(1.5 / 2)
    assert line["Loss/value_loss"] == pytest.approx(1.5)
    assert line["Perf/total_fps"] == 2 * 8 // 2
    for r in two_ranks["ranks"]:
        assert int(r["fam_nres"]) == 4 and len(r["fam_levels"]) == 3
        np.testing.assert_allclose(r["fam_levels"] / 4, 0.5, rtol=0, atol=0)


def test_command_curriculum_decides_on_all_ranks(two_ranks):
    """Rank 1's envs alone would not widen the vx range; the job's mean
    does, so both ranks widen it at the same step."""
    for r in two_ranks["ranks"]:
        np.testing.assert_array_equal(r["vx_before"], [-1.0, 1.0])
        np.testing.assert_array_equal(r["vx_after"], [-1.5, 1.5])


def _single_update_params(model, traj_cls, traj_np, last, recurrent, h0=None):
    one = ppo.PPOConfig(**ONE)
    state = ppo.PPOState(one, model)
    tr = traj_cls(*(torch.as_tensor(traj_np[f]) for f in traj_cls._fields))
    if recurrent:
        h = tuple(tuple(torch.as_tensor(x) for x in c) for c in h0)
        RecurrentPPO(None, model, one, num_steps=T).update(
            state, tr, h, torch.as_tensor(last), perm=torch.arange(N))
    else:
        ret, adv = ppo.compute_gae(one, tr, torch.as_tensor(last))
        ppo.update(one, state, tr, ret, adv, perm=torch.arange(T * N))
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
def test_sharded_update_matches_single_process(two_ranks, kind):
    """One epoch, one minibatch: the mean of the ranks' gradients over
    4 + 4 envs is the gradient over all 8, so the two ranks' update
    equals one process's (rtol 1e-3, atol 1e-5; the advantages are
    normalised over the whole batch in both)."""
    jobs = two_ranks["jobs"]
    if kind == "feedforward":
        prefix, cls, key = "ff", ppo.Transition, "ff_params"
        model = two_ranks["mlp"]
    else:
        prefix, cls, key = "rnn", RecurrentTransition, "rnn_params"
        model = two_ranks["rnn"]
    traj_np = {f: jobs[f"{prefix}.{f}"] for f in cls._fields}
    want = _single_update_params(model, cls, traj_np, jobs[prefix + ".last"],
                                 kind == "recurrent", two_ranks["h0"])
    r0, r1 = two_ranks["ranks"]
    assert np.array_equal(r0[key], r1[key])
    np.testing.assert_allclose(r0[key], want, rtol=1e-3, atol=1e-5)


def test_sharded_update_matches_jax_shard_map(two_ranks):
    """The port's update on two gloo ranks against the JAX update under
    shard_map on two devices, the same per-rank permutations fed: every
    parameter rtol 1e-4 / atol 1e-5, the learning rate exact."""
    r0, r1 = two_ranks["ranks"]
    jstate = two_ranks["jstate"]
    jadv = two_ranks["jadv"]
    np.testing.assert_allclose(np.concatenate([r0["jx_adv"], r1["jx_adv"]],
                                              1), jadv, rtol=1e-5, atol=1e-6)
    model = two_ranks["jx_model"]
    leaves = interop._mlp_leaves(jax.tree.map(np.asarray, jstate.params),
                                 model)
    names = {id(p): n for n, p in model.named_parameters()}
    for p, want in leaves:
        name = names[id(p)]
        assert np.array_equal(r0["jx." + name], r1["jx." + name])
        np.testing.assert_allclose(r0["jx." + name], want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(r0["jx_lr"]) == float(jstate.learning_rate)
    assert float(r0["jx_lr"]) != pytest.approx(5e-4)   # the rule moved it
    np.testing.assert_allclose(float(r0["jx_value_loss"]),
                               float(two_ranks["jmetrics"]["value_loss"]),
                               rtol=1e-5, atol=1e-6)
