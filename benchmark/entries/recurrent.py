"""Entry `recurrent`: training through `RecurrentRunner.learn`, one whole
iteration at a time (a collect of num_steps_per_env env steps that
carries the LSTM state, then the BPTT update).

The program (`dwbc_tpu_torch`) re-unrolls each minibatch's trajectories
from the collect's first carry under the done masks; the plain reference
(`benchmark.reference`) stores the hidden state at every step and
unrolls padded pieces of the trajectories, as rsl_rl does. The program's
session records its first iterations (`first_steps`), each with the
carry it started from and its trajectory (whose `dones_prev` holds the
resets before each step); the reference's session re-steps its own LSTM
from that carry on the program's observations and runs its own update on
the program's trajectory (`follow`).

The update is followed one minibatch step at a time, as an env step is:
each iteration starts from the program's parameters and Adam state, and
at each step the reference computes its own loss, KL and gradients at
the program's parameters, keeps the gradients' norms, and then steps
with the program's clipped gradients at the rate its own adaptive-KL
rule chose, from its own rate of the iteration before. Where the rates
agree this keeps it on the program's parameters; a rate the program
chose otherwise (a wrong KL or rule) parts the two sides' Adam steps by
the rule's factor. Letting it step with its own gradients instead does
not separate: the two formulations sum in other orders, Adam
scales each entry's rounding to a share of the learning rate, and each
step feeds the difference into the next minibatch's forward pass, so
that within three iterations the two sides' policies part by up to
2.4e-3 on sound seeds, as far as the TF32 control's (PERF.md). So
`loss_gap` compares each iteration's loss from the program's
parameters, and `change_gap` the program's parameters against its own
gradients stepped by the reference's Adam at the reference's rates. `grad_gap` compares the
first step's gradient, as the on-policy entry does: at later steps rows
reach the PPO clip's kinks, where the gradient jumps with the last bit
of the ratio. Gradient norms are taken in float64 on both sides.

`plant` puts the faults of benchmark/faults.py under this entry's timed
path (faults.plant reaches an OnPolicyRunner's learn step, which the
recurrent runner does not have), and one of its own: `wrong_rate`, every
rate of the adaptive-KL rule taken 1.5 times too large inside the
update, one decision off.
"""

from __future__ import annotations

import contextlib
import importlib
import math
from typing import List

import torch

from .. import check, faults, portable
from .. import weights as weights_lib
from .. import yardstick
from . import on_policy
from .on_policy import _host, _swapped, sampled_steps

PROGRAM = "dwbc_tpu_torch"
REFERENCE = "benchmark.reference"
# the module of each package whose make_runner builds the recurrent task
REGISTRY = {PROGRAM: PROGRAM + ".utils.task_registry",
            REFERENCE: REFERENCE + ".utils.recurrent_registry"}
# benchmark/faults.py's faults, and learning rates one adaptive-KL
# decision off
FAULTS = faults.FAULTS + ("wrong_rate",)


def _step_loss(cfg, m, std) -> float:
    """One update's loss, averaged over its minibatch steps, with the
    entropy term at `std`, the std the update started from. Both sides
    start an update from the program's parameters, so that term is the
    same number on both: it sets the scale of the relative gap. Without
    it the loss crosses zero near the third update (-6e-3 to 3e-3 on
    sound seeds), where a rounding-level difference reads as a large
    relative gap."""
    entropy = torch.sum(0.5 + 0.5 * math.log(2 * math.pi)
                        + torch.log(std.double()))
    return float(cfg.value_loss_coef * m["value_loss"] + m["surrogate_loss"]
                 - cfg.entropy_coef * entropy)


@contextlib.contextmanager
def _optimizer_steps(runner, out: List[dict]):
    """Append to `out`, at every optimizer step, the clipped gradients it
    steps with ({name: host copy})."""
    names = {id(p): k for k, p in runner.model.named_parameters()}

    def before_step(opt, *_):
        out.append({names[id(p)]: p.grad.detach().to("cpu", copy=True)
                    for group in opt.param_groups
                    for p in group["params"]})
    handle = runner.ppo_state.opt.register_step_pre_hook(before_step)
    try:
        yield
    finally:
        handle.remove()


def _optimizer_state(runner) -> dict:
    """Host copies of the parameters and of Adam's state, by name."""
    opt = runner.ppo_state.opt
    params = dict(runner.model.named_parameters())
    return {"params": {k: p.detach().to("cpu", copy=True)
                       for k, p in params.items()},
            "adam": {k: {s: v.detach().to("cpu", copy=True)
                         for s, v in opt.state[p].items()}
                     for k, p in params.items() if p in opt.state}}


@torch.no_grad()
def _take_state(runner, state: dict) -> None:
    """Load a program's `_optimizer_state` into this runner; Adam's step
    count stays where its optimizer keeps it (the host)."""
    opt = runner.ppo_state.opt
    opt.state.clear()
    for k, p in runner.model.named_parameters():
        p.copy_(state["params"][k])
        if k in state["adam"]:
            opt.state[p] = {s: v.clone() if s == "step" else v.to(p.device)
                            for s, v in state["adam"][k].items()}


def _no_hidden(traj):
    """The trajectory without the reference's stored hidden states, which
    the follower computes itself."""
    return traj._replace(hidden=None) if "hidden" in traj._fields else traj


class Session(on_policy.Session):
    """One recurrent runner of `config["task"]` at the traffic's size,
    with the benchmark's weights loaded. What reads only the runner's
    timers, its newest trajectory and the env is on_policy's."""

    def __init__(self, package: str, config: dict, traffic: dict, seed: int,
                 device, weights=None):
        self.package = package
        registry = importlib.import_module(REGISTRY[package])
        self.env, self.runner, _ = registry.make_runner(
            config["task"], num_envs=traffic["num_envs"], seed=seed,
            device=device)
        self.runner.alg.num_steps = traffic["num_steps_per_env"]
        self.num_envs = self.env.num_envs
        self.steps = traffic["num_steps_per_env"]
        self.device = torch.device(device)
        self._check_sizes(config["sizes"])
        shapes = [(n, tuple(p.shape))
                  for n, p in self.runner.model.named_parameters()]
        self.weights = weights if weights is not None else weights_lib.make(
            shapes, config["policy_init_std"], seed, self.device)
        weights_lib.load(self.runner.model, self.weights)

    def _check_sizes(self, sizes: dict):
        """The configuration file states the sizes as they are run, the
        recurrent policy's widths among them."""
        env, model, cfg = self.env, self.runner.model, self.runner.alg.cfg
        seen = {
            "num_observations": env.num_obs,
            "num_actions": env.num_actions,
            "contact_spheres": len(env.model.geom_body),
            "bodies": env.model.nb,
            "decimation": env.cfg.control.decimation,
            "num_learning_epochs": cfg.num_learning_epochs,
            "num_mini_batches": cfg.num_mini_batches,
            "rnn_type": model.rnn_type,
            "rnn_hidden_size": model.rnn_hidden_size,
            # one cell per memory where the model names no layer count
            "rnn_num_layers": getattr(model, "rnn_num_layers", 1),
            "actor_hidden_dims": [l.out_features
                                  for l in model.actor_layers[:-1]],
            "critic_hidden_dims": [l.out_features
                                   for l in model.critic_layers[:-1]],
            "terrain": env.cfg.terrain.mesh_type,
        }
        wrong = {k: (v, seen[k]) for k, v in sizes.items()
                 if k in seen and seen[k] != v}
        if wrong:
            raise ValueError(f"configuration sizes differ from the run "
                             f"(stated, built): {wrong}")

    # -- what the window runs ----------------------------------------

    def iterate(self):
        """One training iteration through the runner's own entry."""
        self.runner.learn(1, log=None)

    def flops_per_iteration(self) -> int:
        return yardstick.flops_per_iteration(
            self.runner.model, self.num_envs, self.steps,
            self.runner.alg.cfg.num_learning_epochs)

    @contextlib.contextmanager
    def spans(self):
        """Host spans around the calls into each layer: the policy's step,
        env.step and the update (record_function on the runner's objects;
        the program is not edited)."""
        r = self.runner
        with contextlib.ExitStack() as stack:
            for obj, attr, label in ((r.model, "step", "policy.act"),
                                     (r.env, "step", "env.step"),
                                     (r.alg, "update", "learn_step")):
                fn = getattr(obj, attr)

                def traced(*a, _fn=fn, _label=label, **k):
                    with torch.profiler.record_function(_label):
                        return _fn(*a, **k)
                stack.enter_context(_swapped(obj, attr, traced))
            yield

    # -- the program's side of `correct` ------------------------------

    def first_steps(self, n: int = 3) -> dict:
        """Run the first `n` iterations through the window's own call and
        record, on the host: the state they start from; for each
        iteration the parameters and Adam state and the carry it started
        from, its trajectory, the carry and observation after it, its
        bootstrap values, its loss, each minibatch step's clipped
        gradients, and the sampled env steps; each leaf's
        first gradient (its norm); each leaf's change. The update's
        last two arguments are, in both packages, the bootstrap values
        and the permutation's generator."""
        r = self.runner
        p0 = {k: p.detach().clone() for k, p in r.model.named_parameters()}
        rec = {"start": portable.snapshot((r.env_state, r.obs)),
               "iterations": []}
        steps: List[dict] = []
        calls = [0]
        start = [None, None]   # the carry and the optimizer's state
        opt_steps: List[dict] = []
        keep = set(sampled_steps(self.steps))
        env_step, update = r.env.step, r.alg.update

        def recording_step(state, actions, *a):
            t = calls[0] % self.steps
            calls[0] += 1
            if t not in keep:
                return env_step(state, actions, *a)
            before = portable.snapshot(state)
            state, out = env_step(state, actions, *a)
            steps.append({"t": t, "before": before,
                          "actions": portable.snapshot(actions),
                          "robot": portable.snapshot(state.robot),
                          "out": portable.snapshot(out)})
            return state, out

        def recording_update(state, traj, *rest):
            std = r.model.std.detach().clone()
            m = update(state, traj, *rest)
            rec["iterations"].append({
                "loss": _step_loss(r.alg.cfg, m, std),
                "h0": portable.snapshot(start[0]), "state": start[1],
                "traj": portable.snapshot(_no_hidden(traj)),
                "carry": portable.snapshot(r.carry),
                "last_obs": portable.snapshot(r.obs),
                "last_values": portable.snapshot(rest[-2]),
                "opt_steps": list(opt_steps), "steps": list(steps)})
            steps.clear()
            opt_steps.clear()
            return m

        with _optimizer_steps(r, opt_steps), \
                _swapped(r.env, "step", recording_step), \
                _swapped(r.alg, "update", recording_update):
            for _ in range(n):
                start[:] = r.carry, _optimizer_state(r)
                self.iterate()
        rec["loss"] = [it["loss"] for it in rec["iterations"]]
        first = rec["iterations"][0]["opt_steps"][0]
        rec["grad"] = {k: float(torch.linalg.vector_norm(
            g, dtype=torch.float64)) for k, g in first.items()}
        rec["change"] = _host({k: torch.linalg.vector_norm(p.detach() - p0[k])
                               for k, p in r.model.named_parameters()})
        return rec

    # -- the reference's side ------------------------------------------

    def _restep(self, traj, h0, last_obs):
        """The reference's policy re-stepped over the program's
        observations from the program's first carry, reset where the
        program's env reset: means, values, sampled actions (from its own
        copy of the noise stream), their log-probabilities, the hidden
        state each step started from, the carry after the last step and
        the bootstrap values."""
        r = self.runner
        rnn = importlib.import_module(self.package + ".rl.recurrent")
        acr = importlib.import_module(
            self.package + ".models.actor_critic_recurrent")
        hidden = acr.reset(h0, traj.dones_prev[0])
        cols = []
        for obs, dones in zip(traj.obs, traj.dones):
            start = rnn._stack(hidden)
            carry, *out = r.alg.policy_step(hidden, obs, r.noise_gen)
            cols.append((*out, start))
            hidden = acr.reset(carry, dones)
        mu, values, actions, logp, stored = (torch.stack(c)
                                             for c in zip(*cols))
        last_values = r.alg.bootstrap(carry, traj.dones[-1], last_obs)
        return mu, values, actions, logp, stored, carry, last_values

    def follow(self, rec: dict) -> dict:
        """Follow the program's record step by step from this session's
        own state (built from the same seed and weights): compare the
        start; repeat each sampled env step from the program's state and
        actions; re-step the policy on the program's observations from
        the program's carry and compare the means, values, sampled
        actions, the carry after the collect and the bootstrap values;
        run this session's update on the program's trajectory, one
        minibatch step at a time from the program's parameters at its own
        rates (module docstring). Returns the reference's losses, first gradients and
        changes, and the gaps of the env (its start and the sampled steps)
        and of the policy."""
        r = self.runner
        dev, pkg = self.device, self.package
        p0 = {k: p.detach().clone() for k, p in r.model.named_parameters()}
        gaps = {"env_gap": check.nest_gap(rec["start"],
                                          (r.env_state, r.obs), dev),
                "policy_gap": 0.0}
        losses, grad = [], {}
        for i, it in enumerate(rec["iterations"]):
            _take_state(r, it["state"])
            traj = portable.restore(it["traj"], pkg, dev)
            h0 = portable.restore(it["h0"], pkg, dev)
            last_obs = portable.restore(it["last_obs"], pkg, dev)
            (mu, values, actions, logp, stored, carry,
             last_values) = self._restep(traj, h0, last_obs)
            gaps["policy_gap"] = max(
                gaps["policy_gap"], check.tensor_gap(traj.mu, mu),
                check.tensor_gap(traj.values, values),
                check.tensor_gap(traj.actions, actions),
                check.nest_gap(it["carry"], carry, dev),
                check.tensor_gap(it["last_values"], last_values))
            for st in it["steps"]:
                state = portable.restore(st["before"], pkg, dev)
                with torch.no_grad():
                    state, out = r.env.step(state,
                                            st["actions"].to(dev))
                gaps["env_gap"] = max(
                    gaps["env_gap"],
                    check.nest_gap(st["out"], out, dev, ("obs", "rew",
                                   "reset", "time_outs")),
                    check.nest_gap(st["robot"], state.robot, dev))
            std = r.model.std.detach().clone()
            traj = traj._replace(
                values=values, mu=mu, sigma=std.expand_as(mu).clone(),
                log_probs=logp, hidden=stored)
            m = r.alg.update(r.ppo_state, traj, last_values, r.perm_gen,
                             program_grads=it["opt_steps"])
            losses.append(_step_loss(r.alg.cfg, m, std))
            if i == 0:
                grad = _host(m["grad_norms"][0])
        change = {k: torch.linalg.vector_norm(p.detach() - p0[k])
                  for k, p in r.model.named_parameters()}
        return {"loss": losses, "grad": grad, "change": _host(change),
                "gaps": gaps}


def plant(session: Session, fault: str) -> None:
    """Plant one fault of FAULTS (benchmark/faults.py's docstring, and
    `wrong_rate`: inside the update the adaptive-KL rule's every rate
    comes out 1.5 times too large) in the session's runner, either
    package's: the update or the env step."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    r = session.runner
    update = r.alg.update
    if fault == "unchanged":
        def unchanged(*a, **k):
            keep = [p.detach().clone() for p in r.model.parameters()]
            m = update(*a, **k)
            with torch.no_grad():
                for p, k0 in zip(r.model.parameters(), keep):
                    p.copy_(k0)
            return m
        r.alg.update = unchanged
    elif fault == "half_batch":
        def rows(x, h):
            """The first h envs of a carry or of a (N, ...) tensor."""
            if torch.is_tensor(x):
                return x[:h]
            if isinstance(x, tuple):
                return tuple(rows(y, h) for y in x)
            return x

        def half(state, traj, *rest):
            h = traj.obs.shape[1] // 2
            traj = type(traj)(*(None if x is None else x[:, :h]
                                for x in traj))
            return update(state, traj, *(rows(x, h) for x in rest))
        r.alg.update = half
    elif fault == "wrong_rate":
        ppo = importlib.import_module(session.package + ".rl.ppo")
        rule = ppo.adapt_learning_rate

        def wrong(cfg, lr, kl):
            return 1.5 * rule(cfg, lr, kl)

        def wrong_rate(*a, **k):
            with _swapped(ppo, "adapt_learning_rate", wrong):
                return update(*a, **k)
        r.alg.update = wrong_rate
    elif fault == "altered_reward":
        step = r.env.step

        def altered(*a, **k):
            state, out = step(*a, **k)
            return state, out._replace(rew=out.rew * 1.1)
        r.env.step = altered
