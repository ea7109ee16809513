"""Entry `adaptive`: widowGo1 with adaptive arm gains and the OSC
torque-supervision expert, through `OnPolicyRunner.learn` as the
on-policy entry drives widowGo1.

The reference builds the variant from its own registry
(`benchmark.reference.utils.adaptive_registry`: the OSC expert written
from the published equation, envs/widowgo1_adaptive.py); the program
from its task registry, as the on-policy entry does. Everything the
on-policy entry compares is compared, and two more things:

  * `env_gap` also covers each sampled env step's `extras`, the expert's
    target torques and the arm's position and velocity that the torque
    supervision reads (relative gaps, the same measure as the rest of
    the step's outputs);
  * `loss_gap` also covers each PPO learn step's unweighted
    `arm_torques_loss`, the adaptive-gain PD forward model's squared
    error against the targets, as its own relative gap beside the
    step's loss; the larger gap is kept. The published schedule (0,
    1000, 1000) weights the supervision 0 throughout, so the step's loss
    leaves it out, and without this nothing would hold the forward
    model.

`plant` plants benchmark/faults.py's faults and one of its own,
`no_gravity`: the OSC target without its gravity term, which
has to fail `env_gap` (benchmark.calibrate takes it with
`faults.plant = adaptive.plant`, as PERF.md gives the command).
"""

from __future__ import annotations

import importlib
from typing import List, Optional

import torch

from .. import check, faults
from .. import weights as weights_lib
from . import on_policy
from .on_policy import _swapped

PROGRAM = "dwbc_tpu_torch"
REFERENCE = "benchmark.reference"
# the module of each package whose make_runner builds the adaptive task
REGISTRY = {PROGRAM: PROGRAM + ".utils.task_registry",
            REFERENCE: REFERENCE + ".utils.adaptive_registry"}
# benchmark/faults.py's faults, and the expert's target without gravity
FAULTS = faults.FAULTS + ("no_gravity",)
# the arm's 6 dofs among the generalised velocities (base 6, legs 12)
ARM = slice(6 + 12, 6 + 18)
# benchmark/faults.py's own plant, kept where a caller puts this entry's
# `plant` in its place
_PLANT = faults.plant


def _with_torque_losses(losses: List[float],
                        torque: List[Optional[float]]) -> List[float]:
    """Each learn step's loss followed by its unweighted arm torque loss
    (none after a DAgger step, which has no torque branch)."""
    out = []
    for loss, ts in zip(losses, torque):
        out.append(loss)
        if ts is not None:
            out.append(ts)
    return out


def _torque_loss(m) -> Optional[float]:
    ts = m.get("arm_torques_loss")
    return None if ts is None else float(ts)


class Session(on_policy.Session):
    """One runner of widowGo1_adaptive at the traffic's size, with the
    benchmark's weights loaded."""

    def __init__(self, package: str, config: dict, traffic: dict, seed: int,
                 device, weights=None):
        self.package = package
        registry = importlib.import_module(REGISTRY[package])
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
        """The on-policy entry's sizes, and the variant's own: the
        proprioception that the gain actions widen, the history, the
        privileged inputs, DAgger's period and the supervision's flags."""
        super()._check_sizes(sizes)
        env, cfg = self.env, self.runner.cfg
        seen = {
            "num_proprio": env.num_proprio,
            "num_priv": env.num_priv,
            "history_len": env.cfg.env.history_len,
            "dagger_update_freq": cfg.dagger_update_freq,
            "torque_supervision": bool(cfg.torque_supervision
                                       and env.cfg.control.torque_supervision),
            "adaptive_arm_gains": bool(
                cfg.adaptive_arm_gains
                and env.cfg.control.adaptive_arm_gains),
        }
        wrong = {k: (v, seen[k]) for k, v in sizes.items()
                 if k in seen and seen[k] != v}
        if wrong:
            raise ValueError(f"configuration sizes differ from the run "
                             f"(stated, built): {wrong}")

    def first_steps(self, n: int = 3) -> dict:
        """The on-policy record, each PPO step's unweighted arm torque
        loss beside its loss."""
        r = self.runner
        torque: List[Optional[float]] = []
        learn = r.rollout.learn_step

        def keeping(*a, **k):
            m = learn(*a, **k)
            torque.append(_torque_loss(m))
            return m

        with _swapped(r.rollout, "learn_step", keeping):
            rec = super().first_steps(n)
        rec["loss"] = _with_torque_losses(rec["loss"], torque)
        return rec

    def follow(self, rec: dict) -> dict:
        """The on-policy follower, with each PPO step's unweighted arm
        torque loss beside its loss, and each repeated env step's extras
        compared into `env_gap`."""
        r = self.runner
        torque: List[Optional[float]] = []
        extras = []
        learn, step = r.rollout.learn_step, r.env.step

        def keeping_learn(*a, **k):
            m = learn(*a, **k)
            torque.append(_torque_loss(m))
            return m

        def keeping_step(*a, **k):
            state, out = step(*a, **k)
            extras.append(out.extras)
            return state, out

        with _swapped(r.rollout, "learn_step", keeping_learn), \
                _swapped(r.env, "step", keeping_step):
            ref = super().follow(rec)
        ref["loss"] = _with_torque_losses(ref["loss"], torque)
        steps = [st for it in rec["iterations"] for st in it["steps"]]
        gaps = [check.nest_gap(st["out"].fields["extras"], ex, self.device)
                for st, ex in zip(steps, extras)]
        if len(gaps) != len(steps):
            gaps.append(float("inf"))
        ref["gaps"]["env_gap"] = max([ref["gaps"]["env_gap"], *gaps])
        return ref


def plant(session: Session, fault: str) -> None:
    """Plant one fault of FAULTS in the session's runner, either
    package's: benchmark/faults.py's, or `no_gravity`, the expert's
    target less its gravity term g(q), the arm's rows of the RNEA bias at
    zero velocity."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault != "no_gravity":
        _PLANT(session, fault)
        return
    env = session.runner.env
    dynamics = importlib.import_module(session.package + ".sim.dynamics")
    target = env._osc_target

    def no_gravity(state):
        q, qd = state.robot.q, state.robot.qd
        bias = dynamics.rnea_bias(env.model, state.inert, q,
                                  torch.zeros_like(qd))
        return target(state) - bias[:, ARM]
    env._osc_target = no_gravity
