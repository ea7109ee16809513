"""Host-time spans and counters of the training path.

`span(name)` is a context manager that adds the host time between its
enter and exit (`time.perf_counter_ns`) and one call to the current
record under `name`; it never synchronises the device. While a torch
profiler records, it also enters `torch.profiler.record_function(name)`,
so that the span lands on the profiler's clock beside the device
activity; with no profiler it does not enter `record_function` at all.
`count(name, n)` adds to a counter of the current record and to the
counter's process-lifetime total (`total(name)`).

The runners call `begin_iteration(it)` and `end_iteration()` around each
training iteration. An iteration's record is

    {"it": it, "profiled": bool,
     "spans": {name: [calls, ns]}, "counters": {name: n}}

where `profiled` says whether a profiler recorded at any span of it. The
newest RING finished records are kept (`records()`). Spans named
`setup.*` go to the one set-up record (`setup_record()`) wherever they
run; its `top_ns` sums those not nested in another `setup.*` span.
Outside an iteration any other span is timed but kept nowhere, and a
count reaches only the total.

Spans of the training path (the names the benchmark's readers read):
runner.collect, runner.learn (rl/runner.py, rl/recurrent.py);
rollout.policy (the policy's calls of a collect step); env.osc (the
OSC expert's target of a torque-supervised widowGo1 step, before its
physics), env.physics and env.post (an env step's physics substeps and
everything after them);
sim.fk, sim.contact, sim.aba, sim.integrate (one physics substep,
sim/fused.py); ppo.gae, ppo.minibatch, ppo.dagger_minibatch (rl/ppo.py);
inside the recurrent update's ppo.minibatch ppo.unroll (the re-unroll and
the loss), ppo.backward and ppo.step (the KL read, the rate and the Adam
step; rl/recurrent.py);
setup.env, setup.runner (utils/task_registry.make_runner) and
setup.native (loading or building a native library). Counters:
host_sync, each point where the host waits for the card; contact_kernel,
aba_kernel and fk_kernel, each launch of the contact, articulated-body
and forward-kinematics kernels (ops/kernel.py); osc_target, each call of
widowGo1's OSC expert (envs/widowgo1.py).
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

# records kept: more than a 51 s benchmark window holds (go1 at 4096 envs
# ran ~90 iterations in one on an H100 once ABA became one kernel launch)
RING = 1024


def _empty_setup() -> dict:
    return {"spans": {}, "top_ns": 0}


_records: Deque[dict] = collections.deque(maxlen=RING)
_current: Optional[dict] = None
_setup = _empty_setup()
_setup_depth = 0
_totals: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "ns", "_rec", "_t0", "_rf", "_top")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    @property
    def seconds(self) -> float:
        """The host time of the span, once it has exited."""
        return self.ns * 1e-9

    def __enter__(self):
        global _setup_depth
        if self.name.startswith("setup."):
            self._rec = _setup
            self._top = _setup_depth == 0
            _setup_depth += 1
        else:
            self._rec = _current
        if _profiler._is_profiler_enabled:
            if self._rec is _current and _current is not None:
                _current["profiled"] = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _setup_depth
        self.ns = ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = self._rec
        if rec is None:
            return False
        entry = rec["spans"].get(self.name)
        if entry is None:
            rec["spans"][self.name] = [1, ns]
        else:
            entry[0] += 1
            entry[1] += ns
        if rec is _setup:
            _setup_depth -= 1
            if self._top:
                rec["top_ns"] += ns
        return False


def span(name: str) -> _Span:
    """A host-time span named `name` (module docstring)."""
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`'s total, and inside an iteration to the
    current record's counter `name`."""
    _totals[name] = _totals.get(name, 0) + n
    if _current is not None:
        c = _current["counters"]
        c[name] = c.get(name, 0) + n


def begin_iteration(it: int) -> dict:
    """Open the record of iteration `it` and return it; spans and counters
    go to it until end_iteration()."""
    global _current
    _current = {"it": it, "profiled": bool(_profiler._is_profiler_enabled),
                "spans": {}, "counters": {}}
    return _current


def end_iteration() -> None:
    """Close the current iteration's record and keep it."""
    global _current
    if _current is not None:
        _records.append(_current)
        _current = None


def records() -> List[dict]:
    """The newest RING finished iteration records, oldest first."""
    return list(_records)


def setup_record() -> dict:
    return _setup


def total(name: str) -> int:
    """Everything counted under `name` in this process, in iterations or
    not; `reset` keeps it."""
    return _totals.get(name, 0)


def reset() -> None:
    """Forget every record."""
    global _current, _setup, _setup_depth
    _records.clear()
    _current = None
    _setup = _empty_setup()
    _setup_depth = 0
