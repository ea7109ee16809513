"""Entry `on_policy`: training through `OnPolicyRunner.learn`, one whole
iteration at a time (a collect of num_steps_per_env env steps, then a
PPO learn step, or a DAgger step every dagger_update_freq-th iteration
of the dual-head tasks).

The same code drives the program (`dwbc_tpu_torch`) and the plain
reference (`benchmark.reference`): both expose
`utils.task_registry.make_runner` and the same runner surface. The
program's session records its first iterations (`first_steps`); the
reference's session follows them step by step (`follow`).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List

import torch

from .. import check, portable
from .. import weights as weights_lib
from .. import yardstick

PROGRAM = "dwbc_tpu_torch"
REFERENCE = "benchmark.reference"


def sampled_steps(steps: int):
    """The env steps of each collect that the reference repeats from the
    program's state: the first, the last and two between."""
    return sorted({0, steps // 3, 2 * steps // 3, steps - 1})


@contextlib.contextmanager
def _swapped(obj, attr: str, new):
    """obj.attr is `new` inside the block; afterwards whatever the
    instance held before (another wrapper, or nothing) is back."""
    had = attr in vars(obj)
    old = vars(obj).get(attr)
    setattr(obj, attr, new)
    try:
        yield
    finally:
        if had:
            setattr(obj, attr, old)
        else:
            delattr(obj, attr)


@contextlib.contextmanager
def _first_gradients(runner, first: Dict[str, torch.Tensor]):
    """Fill `first` with each leaf's first gradient as its optimizer got
    it: Adam's first moment after the first step that holds the leaf,
    exp_avg / (1 - beta1)."""
    names = {id(p): k for k, p in runner.model.named_parameters()}

    def after_step(opt, *_):
        for group in opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                name = names[id(p)]
                if name not in first and p in opt.state:
                    first[name] = torch.linalg.vector_norm(
                        opt.state[p]["exp_avg"] / (1.0 - beta1))

    opts = [o for o in (runner.ppo_state.opt, runner.ppo_state.hist_opt)
            if o is not None]
    handles = [o.register_step_post_hook(after_step) for o in opts]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _step_loss(cfg, m) -> float:
    """One learn step's loss, averaged over its minibatch steps: the PPO
    loss without its entropy term (a function of the std alone), or the
    DAgger regression loss."""
    if "value_loss" not in m:
        return float(m["hist_latent_loss"])
    return float(cfg.value_loss_coef * m["value_loss"] + m["surrogate_loss"]
                 + m["priv_reg_coef"] * m["priv_reg_loss"]
                 + m["torque_supervision_weight"] * m["arm_torques_loss"])


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return dict(zip(d, torch.stack(list(d.values())).tolist())) if d else {}


class Session:
    """One runner of `config["task"]` at the traffic's size, with the
    benchmark's weights loaded."""

    def __init__(self, package: str, config: dict, traffic: dict, seed: int,
                 device, weights=None):
        self.package = package
        registry = importlib.import_module(package + ".utils.task_registry")
        self.env, self.runner, _ = registry.make_runner(
            config["task"], num_envs=traffic["num_envs"], seed=seed,
            device=device)
        self.runner.rollout.num_steps = traffic["num_steps_per_env"]
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
        """The configuration file states the sizes as they are run."""
        env, cfg = self.env, self.runner.cfg
        seen = {
            "num_observations": env.num_obs,
            "num_actions": env.num_actions,
            "contact_spheres": len(env.model.geom_body),
            "bodies": env.model.nb,
            "decimation": env.cfg.control.decimation,
            "num_learning_epochs": cfg.num_learning_epochs,
            "num_mini_batches": cfg.num_mini_batches,
            "num_heads": cfg.num_heads,
        }
        wrong = {k: (v, seen[k]) for k, v in sizes.items()
                 if k in seen and seen[k] != v}
        if wrong:
            raise ValueError(f"configuration sizes differ from the run "
                             f"(stated, built): {wrong}")

    # -- what the window runs ----------------------------------------

    def iterate(self):
        """One training iteration through the runner's own entry."""
        self.runner.learn(1)

    def nonfinite_rows(self) -> torch.Tensor:
        """(step, env) rows of the newest trajectory whose observation,
        reward or value is not finite, as a device scalar."""
        t = self.runner.last_traj
        ok = (torch.isfinite(t.obs).all(-1) & torch.isfinite(t.rewards).all(-1)
              & torch.isfinite(t.values).all(-1))
        return (~ok).sum()

    def timers(self):
        """(collect s, learn s) of the newest iteration, each closed by a
        device synchronisation inside the runner."""
        return self.runner.last_collection_time, self.runner.last_learn_time

    def env_steps_per_iteration(self) -> int:
        return self.num_envs * self.steps

    def flops_per_iteration(self) -> int:
        return yardstick.flops_per_iteration(
            self.runner.model, self.num_envs, self.steps,
            self.runner.cfg.num_learning_epochs)

    def contact_shape(self):
        """(spheres, envs) of one contact-law launch."""
        return len(self.env.model.geom_body), self.num_envs

    @contextlib.contextmanager
    def spans(self):
        """Host spans around the calls into each layer: the policy's act,
        env.step and the learn step (record_function on the runner's
        objects; the program is not edited)."""
        r = self.runner
        with contextlib.ExitStack() as stack:
            for obj, attr, label in ((r.model, "act_mean", "policy.act"),
                                     (r.env, "step", "env.step"),
                                     (r.rollout, "learn_step", "learn_step")):
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
        iteration its trajectory, the observation after it, whether it
        was a DAgger iteration, its loss, and the sampled env steps (the
        state before, the actions, the robot's state and the outputs
        after); each leaf's first gradient; each leaf's change."""
        r = self.runner
        p0 = {k: p.detach().clone() for k, p in r.model.named_parameters()}
        rec = {"start": portable.snapshot((r.env_state, r.obs)),
               "iterations": []}
        steps: List[dict] = []
        calls = [0]
        keep = set(sampled_steps(self.steps))
        env_step, learn = r.env.step, r.rollout.learn_step

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

        def recording_learn(ppo_state, traj, last_obs, gen, dagger):
            m = learn(ppo_state, traj, last_obs, gen, dagger)
            rec["iterations"].append({
                "dagger": dagger, "loss": _step_loss(r.cfg, m),
                "traj": portable.snapshot(traj),
                "last_obs": portable.snapshot(last_obs),
                "steps": list(steps)})
            steps.clear()
            return m

        first: Dict[str, torch.Tensor] = {}
        with _first_gradients(r, first), \
                _swapped(r.env, "step", recording_step), \
                _swapped(r.rollout, "learn_step", recording_learn):
            for _ in range(n):
                self.iterate()
        rec["loss"] = [it["loss"] for it in rec["iterations"]]
        rec["grad"] = _host(first)
        rec["change"] = _host({k: torch.linalg.vector_norm(p.detach() - p0[k])
                               for k, p in r.model.named_parameters()})
        return rec

    # -- the reference's side ------------------------------------------

    @torch.no_grad()
    def _policy(self, traj, dagger: bool):
        """The reference's act and value on the program's observations,
        and its actions drawn from its own copy of the noise stream."""
        r = self.runner
        model, std = r.model, r.model.std
        ac = importlib.import_module(self.package + ".models.actor_critic")
        mu, values, actions = [], [], []
        for obs in traj.obs:
            mean = model.act_mean(obs, dagger)
            mu.append(mean)
            values.append(model.evaluate(obs))
            actions.append(ac.normal_sample(r.noise_gen, mean, std))
        return torch.stack(mu), torch.stack(values), torch.stack(actions)

    def follow(self, rec: dict) -> dict:
        """Follow the program's record step by step from this session's
        own state (built from the same seed and weights): compare the
        start; repeat each sampled env step from the program's state and
        actions; recompute the policy's means, values and sampled
        actions on the program's observations; run this session's learn
        step on the program's trajectory. Returns the reference's losses,
        first gradients and changes, and the gaps of the env (its start
        and the sampled steps) and of the policy."""
        r = self.runner
        ppo = importlib.import_module(self.package + ".rl.ppo")
        dev, pkg = self.device, self.package
        p0 = {k: p.detach().clone() for k, p in r.model.named_parameters()}
        gaps = {"env_gap": check.nest_gap(rec["start"],
                                          (r.env_state, r.obs), dev),
                "policy_gap": 0.0}
        losses, first = [], {}
        with _first_gradients(r, first):
            for i, it in enumerate(rec["iterations"]):
                dagger = bool(r.cfg.use_dagger
                              and i % r.cfg.dagger_update_freq == 0)
                traj = portable.restore(it["traj"], pkg, dev)
                mu, values, actions = self._policy(traj, dagger)
                gaps["policy_gap"] = max(
                    gaps["policy_gap"], check.tensor_gap(traj.mu, mu),
                    check.tensor_gap(traj.values, values),
                    check.tensor_gap(traj.actions, actions),
                    0.0 if it["dagger"] == dagger else float("inf"))
                for st in it["steps"]:
                    state = portable.restore(st["before"], pkg, dev)
                    args = (float(i + 1),) if r.rollout.has_counter else ()
                    with torch.no_grad():
                        state, out = r.env.step(
                            state, st["actions"].to(dev), *args)
                    gaps["env_gap"] = max(
                        gaps["env_gap"],
                        check.nest_gap(st["out"], out, dev, ("obs", "rew",
                                       "arm_rew", "reset", "time_outs")),
                        check.nest_gap(st["robot"], state.robot, dev))
                std = r.model.std.detach()
                traj = traj._replace(
                    values=values, mu=mu, sigma=std.expand_as(mu).clone(),
                    log_probs=ppo.logp_heads(r.cfg, traj.actions, mu, std))
                last_obs = portable.restore(it["last_obs"], pkg, dev)
                m = r.rollout.learn_step(r.ppo_state, traj, last_obs,
                                         r.perm_gen, dagger)
                losses.append(_step_loss(r.cfg, m))
        change = {k: torch.linalg.vector_norm(p.detach() - p0[k])
                  for k, p in r.model.named_parameters()}
        return {"loss": losses, "grad": _host(first),
                "change": _host(change), "gaps": gaps}

    def close(self):
        self.runner.close()
        self.env = self.runner = None
