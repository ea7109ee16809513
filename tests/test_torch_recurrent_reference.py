"""The port's recurrent path against the benchmark's plain reference, which
follows rsl_rl's formulation: the rollout stores the hidden state at
every step, and the update cuts each env's trajectory at its dones, pads
the pieces, unrolls each from its stored start state and unpads
(benchmark/reference/rl/recurrent.py). The port re-unrolls the whole
trajectory from the collect's first carry under done masks
(dwbc_tpu_torch/rl/recurrent.py); this holds it to the reference.

Both sides get the same weights (benchmark.weights.make, with small
random biases drawn on top so that the hidden-side bias counts), the
same first carry, the same action-noise and permutation streams, and the
same scripted env: observations a fixed function of the step and the
actions, dones where the test puts them. Two sizes: an LSTM of 16 with
heads (16, 8) at 8 envs x 6 steps, every env cut into two or three
pieces; and legged_gym's published widths (LSTM 512, heads 512-256-128)
at 4 envs x 3 steps.

Compared: the rollout's means, values, actions, log-probabilities, last
carry and bootstrap values, bit for bit (the same operations on the same
rows on both sides). After one update of the configuration's 5 epochs x
4 minibatches: the two mean losses and each leaf's first gradient and
parameters, by the norm of the difference over the norm of the
reference's, at most TOL; each leaf's change over the update, at most
CHANGE_TOL. Why these: the padded layout puts each minibatch's rows in
other places and other numbers, so the backward pass sums the same
products in another order; in float32 (eps 1.2e-7) that leaves a few
ulps in a loss or a gradient (measured: at most 5.5e-7 over both sizes)
and in the parameters (8.5e-7). Adam divides each entry's first moment
by the root of its second, so an entry whose gradient is a few ulps from
zero moves by a different share of the learning rate on each side: the
leaves' changes differ more (measured: 1.2e-6 small, 4.6e-5 at the
published widths, where a minibatch is one env). TOL leaves 10x room
over the first readings, CHANGE_TOL 20x; a change of the loss's terms,
of the pieces or of their start states moves these numbers by 1e-3 and
more.

Planted faults: a carry not reset at a done, and a bootstrap value taken
from a carry without the reset; each has to move the rollout.
"""

from typing import NamedTuple

import pytest
import torch

from benchmark import weights
from benchmark.reference.models import actor_critic_recurrent as ref_model
from benchmark.reference.rl import ppo as ref_ppo
from benchmark.reference.rl import recurrent as ref_rl
from benchmark.reference.utils import task_registry as ref_registry
from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.rl import ppo, recurrent
from dwbc_tpu_torch.utils.task_registry import TASKS

TOL = 1e-5
CHANGE_TOL = 1e-3
SEED = 2 ** 31 + 17
CASES = {
    "small": dict(envs=8, steps=6, rnn_hidden_size=16,
                  actor_hidden_dims=(16, 8), critic_hidden_dims=(16, 8)),
    "published": dict(envs=4, steps=3, rnn_hidden_size=512,
                      actor_hidden_dims=(512, 256, 128),
                      critic_hidden_dims=(512, 256, 128)),
}


def resets(envs: int, steps: int) -> torch.Tensor:
    """(steps, envs) dones: env e ends an episode after step 1 + e % 2,
    every other env again two steps later, and envs 1, 2 after the last
    step, so that at 8 x 6 each env is cut into two or three pieces."""
    d = torch.zeros((steps, envs), dtype=torch.bool)
    for e in range(envs):
        first = min(1 + e % 2, steps - 1)
        d[first, e] = True
        if e % 2 == 0 and first + 2 < steps:
            d[first + 2, e] = True
    d[-1, 1:3] = True
    return d


class Out(NamedTuple):
    obs: torch.Tensor
    rew: torch.Tensor
    reset: torch.Tensor
    time_outs: torch.Tensor
    episode_stats: dict
    num_resets: torch.Tensor


class ScriptedEnv:
    """Observations tanh(base[t + 1] + actions @ mix), rewards from them,
    dones from a script (time-outs at every other done); the state is
    the step."""

    def __init__(self, dones: torch.Tensor, num_obs=48, num_actions=12):
        g = torch.Generator().manual_seed(5)
        self.dones = dones
        self.num_envs = dones.shape[1]
        self.num_obs, self.num_actions = num_obs, num_actions
        self.device = torch.device("cpu")
        self.base = torch.randn((dones.shape[0] + 1, self.num_envs, num_obs),
                                generator=g)
        self.mix = 0.3 * torch.randn((num_actions, num_obs), generator=g)

    def first_obs(self):
        return torch.tanh(self.base[0])

    def step(self, t, actions):
        obs = torch.tanh(self.base[t + 1] + actions @ self.mix)
        done = self.dones[t]
        rew = obs[:, 0] - 0.1 * actions.square().mean(-1)
        stats = {"reward_sum": rew.sum(), "len_sum": done.sum().float()}
        return t + 1, Out(obs, rew, done, done & (torch.arange(
            self.num_envs) % 2 == 0), stats, done.sum())


def models(case: str):
    """(the port's model, the reference's) with the same weights."""
    c = CASES[case]
    widths = {k: c[k] for k in ("rnn_hidden_size", "actor_hidden_dims",
                                "critic_hidden_dims")}
    port = ActorCriticRecurrent(num_obs=48, num_actions=12, **widths)
    ref = ref_model.ActorCriticRecurrent(48, 12, **widths)
    shapes = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    w = weights.make(shapes, [1.0] * 12, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    for n, t in w.items():
        if n.endswith("bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
    weights.load(port, w)
    weights.load(ref, w)
    return port, ref


def first_carry(envs: int, hidden: int):
    g = torch.Generator().manual_seed(4)
    pair = lambda: tuple(0.5 * torch.randn((envs, hidden), generator=g)
                         for _ in range(2))
    return (pair(), pair())


def collect_both(case: str, port_step=None):
    """Both sides' collects over the same scripted env, from the same
    carry and noise stream; `port_step` replaces the port's model.step."""
    c = CASES[case]
    port, ref = models(case)
    if port_step is not None:
        port.step = port_step(port.step)
    env = ScriptedEnv(resets(c["envs"], c["steps"]))
    carry = first_carry(c["envs"], c["rnn_hidden_size"])
    last_dones = torch.arange(c["envs"]) % 3 == 0
    alg_p = recurrent.RecurrentPPO(env, port, TASKS["go1_flat_lstm"].ppo_cfg,
                                   c["steps"])
    alg_r = ref_rl.RecurrentPPO(env, ref, ref_registry.TASKS["go1"].ppo_cfg,
                                c["steps"])
    got_p = alg_p.collect(0, env.first_obs(), carry, last_dones,
                          torch.Generator().manual_seed(7))
    got_r = alg_r.collect(0, env.first_obs(), carry, last_dones,
                          torch.Generator().manual_seed(7))
    return (alg_p, got_p), (alg_r, got_r), carry


def rollout_pairs(got_p, got_r):
    """(name, port's, reference's) of everything the rollout hands on."""
    _, _, carry_p, _, traj_p, last_p, _, _ = got_p
    _, _, carry_r, _, traj_r, last_r = got_r
    pairs = [(k, getattr(traj_p, k), getattr(traj_r, k))
             for k in ("mu", "values", "actions", "log_probs", "obs")]
    flat = lambda c: [t for pair in c for t in pair]
    pairs += [(f"carry.{i}", a, b)
              for i, (a, b) in enumerate(zip(flat(carry_p), flat(carry_r)))]
    return pairs + [("last_values", last_p, last_r)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_the_rollout_equals_the_reference_bit_for_bit(case):
    (_, got_p), (_, got_r), _ = collect_both(case)
    traj_r = got_r[4]
    # the script cuts every env into two or three pieces at the small size
    starts, _, masks = ref_rl.split_and_pad(traj_r.dones)
    pieces = starts.sum(0)
    if case == "small":
        assert pieces.min() == 2 and pieces.max() == 3, pieces
    assert masks.sum() == traj_r.dones.numel()
    for name, a, b in rollout_pairs(got_p, got_r):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", list(CASES))
def test_one_update_equals_the_padded_bptt(case):
    (alg_p, got_p), (alg_r, got_r), h0 = collect_both(case)
    start = {n: p.detach().clone() for n, p in alg_r.model.named_parameters()}
    states, firsts, metrics = [], [], []
    for alg, lib, traj, last, args in (
            (alg_p, ppo, got_p[4], got_p[5], (h0,)),
            (alg_r, ref_ppo, got_r[4], got_r[5], ())):
        state = lib.PPOState(alg.cfg, alg.model)
        first = {}
        names = {id(p): n for n, p in alg.model.named_parameters()}

        def keep_first(opt, *_, first=first, names=names):
            if not first:
                for group in opt.param_groups:
                    for p in group["params"]:
                        first[names[id(p)]] = p.grad.detach().clone()
        hook = state.opt.register_step_pre_hook(keep_first)
        metrics.append(alg.update(state, traj, *args, last,
                                  torch.Generator().manual_seed(8)))
        hook.remove()
        states.append(state)
        firsts.append(first)
    assert states[0].counter == states[1].counter == 1
    assert states[0].learning_rate == states[1].learning_rate
    for k in ("value_loss", "surrogate_loss"):
        assert rel(metrics[0][k], metrics[1][k]) <= TOL, k
    assert sorted(firsts[0]) == sorted(firsts[1])
    for n in firsts[0]:
        assert rel(firsts[0][n], firsts[1][n]) <= TOL, n
    params_r = dict(alg_r.model.named_parameters())
    for n, p in alg_p.model.named_parameters():
        p, r = p.detach(), params_r[n].detach()
        assert rel(p, r) <= TOL, n
        assert rel(p - start[n], r - start[n]) <= CHANGE_TOL, n


def _no_reset(step):
    """A carry never reset at a done."""
    return lambda carry, obs, dones=None: step(carry, obs, None)


def _bootstrap_without_reset(step, steps=CASES["small"]["steps"]):
    """The bootstrap call (the one after the collect's steps) drops its
    reset; the steps keep theirs."""
    calls = [0]

    def fault(carry, obs, dones=None):
        calls[0] += 1
        return step(carry, obs, None if calls[0] > steps else dones)
    return fault


@pytest.mark.parametrize("fault, moved", [
    (_no_reset, "mu"), (_bootstrap_without_reset, "last_values")],
    ids=["carry_not_reset", "bootstrap_without_reset"])
def test_a_planted_fault_moves_the_rollout(fault, moved):
    (_, got_p), (_, got_r), _ = collect_both("small", port_step=fault)
    gaps = {name: rel(a, b) for name, a, b in rollout_pairs(got_p, got_r)}
    assert gaps[moved] > 1e-3, gaps
