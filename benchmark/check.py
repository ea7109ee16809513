"""The comparison that decides `correct`: the program's first training
iterations against the plain reference, which follows them step by step.

Following from the seed alone does not separate sound runs from the
TF32 control: the kernel's rounding and TF32's both grow through the
envs' contacts, resets and the learning, until a later iteration's loss
differs by up to a third on some seeds either way (PERF.md). So the
reference is handed what the program produced and repeats each stage
from it: it builds the start from the seed and compares it, and it
repeats sampled env steps from the program's state and actions; it recomputes
the policy's means, values and sampled actions on the program's
observations; and it runs its own learn steps, from its own parameters,
on the program's trajectories.

The numbers, each with its limit in `limits/<cell>.json`, which has to
hold all of them:
  env_gap            the initial env state and observation against the
                     reference's own from the seed, and the sampled env
                     steps: observations, rewards, reset and time-out
                     flags, and the robot's state after the step, against
                     the reference's step from the same state and
                     actions;
  policy_gap         the collected means, values and actions against the
                     reference's on the same observations;
  loss_gap           the largest relative gap between the two sides'
                     loss over the first iterations;
  grad_gap           the worst leaf's gap between the norms of its first
                     gradient, over the reference's norm of that leaf or
                     of the median leaf, whichever is larger;
  change_gap         the same of each leaf's change over the first
                     iterations, leaving out the leaves whose first
                     gradient in the reference is under a thousandth of
                     the median leaf's (they move by round-off alone).
A reading or a limit that is missing, or a reading that is not finite,
fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

from . import portable

NUMBERS = ("env_gap", "policy_gap", "loss_gap", "grad_gap", "change_gap")

# a leaf whose reference gradient is under this share of the median
# leaf's is left out of the change
NOUGHT = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger (a leaf
    missing on the program's side reads as 0)."""
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor)
            for k in leaves]


def _top(xs) -> float:
    return math.inf if any(math.isnan(x) for x in xs) else max(xs)


def tensor_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """Relative gap of two tensors: the norm of their difference over the
    reference's norm (float), or the entries that differ over the
    reference's non-zero entries (bool, int). Entries that are not finite
    on both sides count as equal; on one side only, the gap is inf."""
    p = p.to(r.device)
    if p.shape != r.shape:
        return math.inf
    if not r.dtype.is_floating_point:
        diff = int((p != r).sum())
        return diff / max(1, int((r != 0).sum())) if diff else 0.0
    p, r = p.double(), r.double()
    bad = ~torch.isfinite(r)
    if bool((bad != ~torch.isfinite(p)).any()):
        return math.inf
    num = float(torch.linalg.vector_norm(torch.where(bad, 0.0, p - r)))
    if num == 0.0:
        return 0.0
    den = float(torch.linalg.vector_norm(torch.where(bad, 0.0, r)))
    return num / den if den > 0 else math.inf


def nest_gap(snap, live, device, fields: Sequence[str] = ()) -> float:
    """The largest tensor_gap over the tensors of a program snapshot and
    the reference's nest of the same layout (only the named top-level
    fields, where given). A tensor on one side only reads inf."""
    a = dict(portable.leaves(snap))
    b = dict(portable.leaves(live))
    if fields:
        keep = lambda k: k.split(".")[1] in fields
        a = {k: v for k, v in a.items() if keep(k)}
        b = {k: v for k, v in b.items() if keep(k)}
    if set(a) != set(b):
        return math.inf
    return max((tensor_gap(a[k], b[k]) for k in a), default=0.0)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared (NUMBERS), from the program's record and the
    reference's readings."""
    if len(prog["loss"]) != len(ref["loss"]):
        steps = [math.inf]
    else:
        steps = [abs(p - r) / abs(r) if r else math.inf
                 for p, r in zip(prog["loss"], ref["loss"])]
    leaves = sorted(ref["grad"])
    median_grad = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in sorted(ref["change"])
              if ref["grad"].get(k, 0.0) >= NOUGHT * median_grad]
    return {"loss_gap": _top(steps),
            "grad_gap": _top(_leaf_gaps(prog["grad"], ref["grad"], leaves)),
            "change_gap": _top(_leaf_gaps(prog["change"], ref["change"],
                                          moving)),
            **ref["gaps"]}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number of NUMBERS read, finite and within its limit."""
    return all(k in nums and k in limits and math.isfinite(nums[k])
               and nums[k] <= limits[k] for k in NUMBERS)


def lines(nums: Dict[str, float], limits: Dict[str, float]):
    return [f"{k} {nums.get(k)!r} limit {limits.get(k)!r}" for k in NUMBERS]
