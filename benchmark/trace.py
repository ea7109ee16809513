"""The traced iterations: torch.profiler over two more whole training
iterations, reduced to the records the per-layer readers read, written
compressed to `traces/<cell>.json.gz`, and the `breakdown`.

The first traced iteration records the card's activity alone, so that
the host runs as it does in the window: the device metrics (busy and
idle time, kernels, the contact kernel's time) come from it. The second
records the host's operator calls and the benchmark's spans as well,
which slows the host about twofold: the breakdown's idle gaps, labelled
by what the host was doing, come from it.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
import time
from typing import Dict, List

import torch

from . import yardstick

TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traces")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.iteration"


def device_iteration(session) -> dict:
    """Profile one iteration of `session` with the card's activity alone
    and return its records: `window` (start, end) in ns, from a marker
    kernel launched as the iteration starts to one launched once it has
    returned; `device` [(name, start, end, kind)] of every device
    operation (kind: kernel, gpu_memcpy or gpu_memset), the markers
    left out; `wall_s`, the iteration's wall time on the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    marks = torch.zeros(2, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marks[0].fill_(1.0)
        session.iterate()
        marks[1].fill_(1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window, device = between_marks(
        [(e.name(), e.start_ns(), e.end_ns(), kind)
         for e in prof.profiler.kineto_results.events()
         if (kind := _kind(e)) in DEVICE_ACTIVITIES])
    return {"window": window, "device": device, "wall_s": wall}


def between_marks(device):
    """((start of the first operation, end of the last), the operations
    between them): the first and the last are the markers."""
    if len(device) < 2:
        raise RuntimeError("the profiler recorded no device operation")
    first = min(device, key=lambda d: d[1])
    last = max(device, key=lambda d: d[2])
    return ((first[1], last[2]),
            [d for d in device if d is not first and d is not last])


def host_iteration(session) -> dict:
    """Profile one iteration of `session` with the host's operator calls
    and the benchmark's host spans on, and return its records: `window`
    (start, end) of the iteration in ns, the card synchronised inside
    it; `device` as in device_iteration; `spans` [(name, start, end)] of
    the benchmark's host spans; `ops` [(name, start, end, thread)] of the
    host's outermost operator calls; `wall_s`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with session.spans(), record_function(WINDOW_SPAN):
            session.iterate()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, spans, ops = [], [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_ACTIVITIES:
            device.append((e.name(), e.start_ns(), e.end_ns(), kind))
        elif kind == "user_annotation":
            if e.name() == WINDOW_SPAN:
                window = (e.start_ns(), e.end_ns())
            else:
                spans.append((e.name(), e.start_ns(), e.end_ns()))
        elif kind == "cpu_op":
            ops.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no iteration span")
    lo, hi = window
    device = [d for d in device if d[2] > lo and d[1] < hi]
    return {"window": window, "device": device, "spans": spans,
            "ops": _outermost(ops), "wall_s": wall}


def _kind(e) -> str:
    """The event's activity: kernel, gpu_memcpy, gpu_memset,
    gpu_user_annotation, user_annotation or cpu_op (read from the event
    where torch gives it, else from its device, flag and name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    note = e.is_user_annotation()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if note:
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if note else "cpu_op"


def _outermost(ops):
    """The operator calls not nested in another on their thread."""
    out, ends = [], {}
    for name, s, e, tid in sorted(ops, key=lambda o: (o[3], o[1], -o[2])):
        if s >= ends.get(tid, -1):
            out.append((name, s, e, tid))
            ends[tid] = e
    return out


def busy_ns(rec: dict) -> float:
    lo, hi = rec["window"]
    return yardstick.union_seconds((max(d[1], lo), min(d[2], hi))
                                   for d in rec["device"])


class _Nested:
    """Innermost of properly nested (name, start, end) intervals that
    covers a time: the latest-starting one, else its enclosing ones."""

    def __init__(self, intervals):
        self.iv = sorted(intervals, key=lambda x: (x[1], -x[2]))
        self.starts = [x[1] for x in self.iv]
        self.parent, stack = [], []
        for i, (_, s, e) in enumerate(self.iv):
            while stack and self.iv[stack[-1]][2] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.iv[i][2] < t:
            i = self.parent[i]
        return self.iv[i][0] if i >= 0 else None


class _Outermost:
    """The host operator call running at a time on any thread (the
    latest-starting one where threads overlap)."""

    def __init__(self, ops):
        threads = collections.defaultdict(list)
        for name, s, e, tid in ops:
            threads[tid].append((name, s, e))
        self.threads = [sorted(v, key=lambda x: x[1])
                        for v in threads.values()]
        self.starts = [[x[1] for x in v] for v in self.threads]

    def at(self, t):
        best = None
        for iv, starts in zip(self.threads, self.starts):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][2] >= t and (best is None
                                             or iv[i][1] > best[1]):
                best = iv[i]
        return best[0] if best else None


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing: the benchmark's span and the
    outermost operator call that covered the middle of each gap
    ("python" where no operator ran)."""
    by_op: Dict[str, float] = collections.defaultdict(float)
    for name, s, e, _ in rec["device"]:
        by_op[name] += (e - s) * 1e-9
    lo, hi = rec["window"]
    gaps = yardstick.idle_gaps([d[1:3] for d in rec["device"]], lo, hi)
    spans, ops = _Nested(rec["spans"]), _Outermost(rec["ops"])
    by_gap: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        label = f"{spans.at(mid) or 'runner'} > {ops.at(mid) or 'python'}"
        by_gap[label] += (e - s) * 1e-9
    first = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:160], v] for k, v in first(by_op)],
            "idle_gaps": [[k[:160], v] for k, v in first(by_gap)]}


def write(cell: str, dev: dict, rec: dict, extra: dict) -> str:
    """traces/<cell>.json.gz: the records of both traced iterations
    (`device_only` of device_iteration, the rest of host_iteration;
    operator names interned) and the run's counts; one file per cell,
    replaced by the next traced run."""
    os.makedirs(TRACE_DIR, exist_ok=True)
    names: List[str] = []
    index: Dict[str, int] = {}

    def intern(n):
        if n not in index:
            index[n] = len(names)
            names.append(n)
        return index[n]
    doc = {"names": None,
           "device_only": {"window": dev["window"], "wall_s": dev["wall_s"],
                           "device": [(intern(n), s, e, intern(k))
                                      for n, s, e, k in dev["device"]]},
           "window": rec["window"], "wall_s": rec["wall_s"],
           "device": [(intern(n), s, e, intern(k))
                      for n, s, e, k in rec["device"]],
           "spans": [(intern(n), s, e) for n, s, e in rec["spans"]],
           "ops": [(intern(n), s, e, t) for n, s, e, t in rec["ops"]],
           **extra}
    doc["names"] = names
    path = os.path.join(TRACE_DIR, cell + ".json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)
    return path
