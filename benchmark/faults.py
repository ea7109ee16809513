"""Faults planted under a session's timed path, to show that the
comparison fails them (benchmark/tests/test_bench_faults.py on the CPU,
benchmark/calibrate.py on the card for the limits' upper readings).

  unchanged       every learn step returns the parameters unchanged;
  half_batch      the learn step sees half of the envs, and its means are
                  taken over the rest;
  altered_reward  the env step's reward comes out 10% too large.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered_reward")


def plant(session, fault: str) -> None:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    r = session.runner
    if fault == "unchanged":
        learn = r.rollout.learn_step

        def unchanged(*a, **k):
            keep = [p.detach().clone() for p in r.model.parameters()]
            m = learn(*a, **k)
            with torch.no_grad():
                for p, k0 in zip(r.model.parameters(), keep):
                    p.copy_(k0)
            return m
        r.rollout.learn_step = unchanged
    elif fault == "half_batch":
        learn = r.rollout.learn_step

        def half(ppo_state, traj, last_obs, gen, dagger):
            h = last_obs.shape[0] // 2
            return learn(ppo_state, type(traj)(*(x[:, :h] for x in traj)),
                         last_obs[:h], gen, dagger)
        r.rollout.learn_step = half
    elif fault == "altered_reward":
        step = r.env.step

        def altered(*a, **k):
            state, out = step(*a, **k)
            return state, out._replace(rew=out.rew * 1.1)
        r.env.step = altered
