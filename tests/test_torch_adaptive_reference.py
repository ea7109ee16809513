"""The port's widowGo1_adaptive against the benchmark's plain reference of
the variant (benchmark/reference/envs/widowgo1_adaptive.py, written from
the published equations with dense Cholesky solves, and
utils/adaptive_registry.py), on the CPU at 8 envs, both sides built from
one seed and handed the same weights (benchmark.weights.make).

Compared:
  * env steps from one carried state whose arm is bent away from its
    default pose: observations, both rewards, resets and time-outs, and
    the three extras of the torque supervision (the OSC expert's target
    torques, the arm's position and velocity);
  * `_pd_torques` with adaptive gains, some of them floored at 0, and a
    hand-written kp = max(kp + delta, 0), kd = 2 sqrt(kp);
  * one PPO learn step on the port's trajectory, at the published
    supervision weight (0) and at weight 1: the loss, the unweighted
    arm_torques_loss, each leaf's first gradient and the parameters
    after it.

Tolerances, each relative (norm of the difference over the reference's):
  * STEP_TOL 1e-5 for the env step. The two sides run the same
    operations but for the expert's solves (the port's column-by-column
    Cholesky with a pivot floor against LAPACK's), whose rounding the
    damped task-space inverse scales by its condition number. The arm's
    default pose (all six angles 0) puts the forearm-roll and
    wrist-rotate axes in line, a singular jacobian: there the damping
    1e-4 sets the condition near 1e6, and the two float32 targets part
    by ~3e-3 on rounding alone. Bent by BEND, the targets part by 4.6e-7
    (measured) and every other output by 0 (the targets feed nothing of
    the step). 1e-5 leaves 20x room; the gravity term dropped moves the
    targets by 0.24, kd = kp the arm's velocity by 0.42.
  * the torque law and the learn step run the same operations on both
    sides in the same order: equal to the last bit, but for the Adam
    step's parameters, held at 1e-6 (float32 rounding of one step from
    the same gradients, measured 0).
"""

import dataclasses

import pytest
import torch

from benchmark import check, portable, weights
from benchmark.reference.rl import ppo as ref_ppo
from benchmark.reference.utils import adaptive_registry
from dwbc_tpu_torch.rl import ppo
from dwbc_tpu_torch.rl import runner as runner_lib
from dwbc_tpu_torch.utils import task_registry

ENVS, STEPS = 8, 3
SEED = 2 ** 31 + 20
STEP_TOL = 1e-5
PARAM_TOL = 1e-6
# the arm's six joint angles for the carried state: waist, shoulder,
# elbow, forearm roll, wrist angle, wrist rotate
BEND = (0.3, -0.4, 0.6, 0.2, 0.8, -0.3)
EXTRAS = ("target_arm_torques", "current_arm_dof_pos", "current_arm_dof_vel")
OUTS = ("obs", "rew", "arm_rew", "reset", "time_outs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runners():
    """(the port's runner, the reference's) with the same weights, and
    the weights."""
    _, port, _ = task_registry.make_runner("widowGo1_adaptive",
                                           num_envs=ENVS, seed=SEED,
                                           device="cpu")
    _, ref, _ = adaptive_registry.make_runner("widowGo1_adaptive", ENVS,
                                              seed=SEED, device="cpu")
    shapes = [(n, tuple(p.shape)) for n, p in port.model.named_parameters()]
    init_std = [0.8, 1.0, 1.0] * 4 + [1.0] * 12
    w = weights.make(shapes, init_std, SEED, "cpu")
    weights.load(port.model, w)
    weights.load(ref.model, w)
    return port, ref, w


def bent_state(port):
    """The port's state after its reset, the arm bent to BEND, and the
    same state on the reference's classes."""
    state = port.env_state
    q = state.robot.q.clone()
    q[:, 7 + 12:7 + 18] = torch.tensor(BEND)
    qd = state.robot.qd.clone()
    qd[:, 6 + 12:6 + 18] = 0.1 * torch.arange(1.0, 7.0)
    state = dataclasses.replace(state, robot=dataclasses.replace(
        state.robot, q=q, qd=qd))
    snap = portable.snapshot(state)
    return (portable.restore(snap, "dwbc_tpu_torch", "cpu"),
            portable.restore(snap, "benchmark.reference", "cpu"))


def actions(seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return 0.5 * torch.randn((ENVS, 24), generator=g)


def step_gaps(port, ref):
    """The largest gap of each compared output over STEPS steps from the
    bent state, the same actions on both sides."""
    sp, sr = bent_state(port)
    gaps = {}
    with torch.no_grad():
        for t in range(STEPS):
            a = actions(t)
            sp, op = port.env.step(sp, a, 1.0)
            sr, orr = ref.env.step(sr, a, 1.0)
            pairs = [(k, getattr(op, k), getattr(orr, k)) for k in OUTS]
            pairs += [(k, op.extras[k], orr.extras[k]) for k in EXTRAS]
            pairs += [("robot", sp.robot.q, sr.robot.q)]
            for k, a_, b_ in pairs:
                gaps[k] = max(gaps.get(k, 0.0), check.tensor_gap(a_, b_))
    return gaps


def test_env_steps_from_a_bent_arm_agree(runners):
    port, ref, _ = runners
    gaps = step_gaps(port, ref)
    assert max(gaps.values()) <= STEP_TOL, gaps


def test_the_expert_is_not_trivially_equal(runners):
    """The targets are torques of a few N m, not zeros, and the arm state
    is the bent one: the comparison above sees the expert at work."""
    port, _, _ = runners
    sp, _ = bent_state(port)
    with torch.no_grad():
        _, out = port.env.step(sp, actions(0), 1.0)
    tau = out.extras["target_arm_torques"]
    assert float(tau.abs().max()) > 0.5
    assert torch.equal(out.extras["current_arm_dof_pos"],
                       torch.tensor(BEND).expand(ENVS, 6))


def test_pd_torques_with_adaptive_gains(runners):
    port, ref, _ = runners
    g = torch.Generator().manual_seed(11)
    a = torch.randn((ENVS, 24), generator=g)
    a[:, 18:] = 8.0 * torch.randn((ENVS, 6), generator=g)   # some kp < 0
    pos = 0.3 * torch.randn((ENVS, 18), generator=g)
    vel = torch.randn((ENVS, 18), generator=g)
    ms = 0.9 + 0.2 * torch.rand((ENVS, 18), generator=g)
    tau_p = port.env._pd_torques(a, pos, vel, ms)
    tau_r = ref.env._pd_torques(a, pos, vel, ms)
    assert torch.equal(tau_p, tau_r)
    # written out: the arm's kp = max(kp + delta, 0), kd = 2 sqrt(kp)
    env = ref.env
    kp = torch.clamp(env.p_gains[12:] + a[:, 18:], min=0.0)
    assert bool((kp == 0).any()) and bool((kp > 0).any())
    target = (a[:, 12:18] * ms[:, 12:] * env.action_scale[12:]
              + env.default_dof_pos[12:18])
    arm = kp * (target - pos[:, 12:]) - 2.0 * torch.sqrt(kp) * vel[:, 12:]
    lim = env.torque_limits[12:18]
    assert torch.equal(tau_r[:, 12:18], torch.clamp(arm, -lim, lim))


def _learn(runner, ppo_lib, traj, last_obs, w, weight: float):
    """One PPO learn step of `runner` from the weights `w` and a fresh
    optimizer (`ppo_lib`'s, the runner's package's), on `traj` at
    supervision weight `weight`: (metrics, each leaf's first gradient)."""
    weights.load(runner.model, w)
    s = runner.cfg.torque_supervision_schedule
    cfg = dataclasses.replace(runner.cfg,
                              torque_supervision_schedule=(weight, *s[1:]))
    state = ppo_lib.PPOState(cfg, runner.model)
    first = {}
    names = {id(p): n for n, p in runner.model.named_parameters()}

    def keep(opt, *_):
        if not first:
            for group in opt.param_groups:
                for p in group["params"]:
                    first[names[id(p)]] = p.grad.detach().clone()
    state.opt.register_step_pre_hook(keep)
    runner.rollout.cfg = cfg
    try:
        m = runner.rollout.learn_step(state, traj, last_obs,
                                      torch.Generator().manual_seed(5),
                                      False)
    finally:
        runner.rollout.cfg = runner.cfg
    return m, first


@pytest.mark.parametrize("weight", [0.0, 1.0], ids=["published", "weight1"])
def test_one_learn_step_agrees(runners, weight):
    port, ref, w = runners
    weights.load(port.model, w)
    rollout = runner_lib.Rollout(port.env, port.model, port.cfg, STEPS)
    sp, _ = bent_state(port)
    _, last_obs, traj, _, _ = rollout.collect(
        sp, port.obs, 1.0, torch.Generator().manual_seed(6), False)
    # the torque branch has rows to fit
    assert float(traj.target_arm_torques.abs().max()) > 0.5
    traj_r = portable.restore(portable.snapshot(traj), "benchmark.reference",
                              "cpu")
    mp, gp = _learn(port, ppo, traj, last_obs, w, weight)
    mr, gr = _learn(ref, ref_ppo, traj_r, last_obs.clone(), w, weight)
    assert mp["torque_supervision_weight"] == weight
    for k in ("value_loss", "surrogate_loss", "priv_reg_loss",
              "arm_torques_loss"):
        assert torch.equal(mp[k], mr[k]), k
    assert float(mp["arm_torques_loss"]) > 0
    assert sorted(gp) == sorted(gr)
    for n in gp:
        assert torch.equal(gp[n], gr[n]), n
    params_r = dict(ref.model.named_parameters())
    for n, p in port.model.named_parameters():
        assert check.tensor_gap(p.detach(), params_r[n].detach()) \
            <= PARAM_TOL, n


def _no_gravity(env, monkeypatch):
    monkeypatch.setattr(env, "_osc_gravity", lambda state: 0.0)


def _kd_is_kp(env, monkeypatch):
    monkeypatch.setattr(env, "_arm_damping", lambda kp: kp)


@pytest.mark.parametrize("fault, moved", [
    (_no_gravity, "target_arm_torques"), (_kd_is_kp, "current_arm_dof_vel")],
    ids=["gravity_dropped", "kd_is_kp"])
def test_a_planted_fault_in_the_reference_fails(runners, fault, moved,
                                               monkeypatch):
    port, ref, _ = runners
    fault(ref.env, monkeypatch)
    gaps = step_gaps(port, ref)
    assert gaps[moved] > 100 * STEP_TOL, gaps
