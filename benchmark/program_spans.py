"""The program's own spans and counters (`dwbc_tpu_torch.utils.spans`)
over the window, for the per-layer readers in metrics/.

The program keeps a record of every training iteration it ran, newest
last: `{it, profiled, spans: {name: [calls, ns]}, counters: {name: n}}`.
The window's iterations are the last `rec["window"]["iterations"]`
records that ran with no profiler attached (the traced iterations run
after the window and are marked `profiled`). A reading is taken only
where those records' `runner.collect` seconds sum to the window's
`collect_s`, the sum of the runner's collect timer, so that a reader
never reads other iterations than the window's. A program without the
span module (an older one) gives no reading.
"""

from __future__ import annotations

from typing import List, Optional

# the relative difference allowed between the picked records' collect
# seconds and the window's
MATCH = 1e-6


def program_records():
    """(the program's iteration records, its set-up record), or None where
    the program has no span module."""
    try:
        from dwbc_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records(), spans.setup_record()


def window_records(rec) -> Optional[List[dict]]:
    """The records of the window's iterations, or None where they cannot
    be told (no span module, too few records, or collect seconds that do
    not match the window's)."""
    got = program_records()
    n = rec["window"]["iterations"]
    if got is None or not n:
        return None
    plain = [r for r in got[0] if not r["profiled"]]
    if len(plain) < n:
        return None
    picked = plain[-n:]
    collect_s = sum(r["spans"].get("runner.collect", (0, 0))[1]
                    for r in picked) * 1e-9
    want = rec["window"]["collect_s"]
    if abs(collect_s - want) > MATCH * abs(want):
        return None
    return picked


def span_ms_per_step(rec, name: str) -> Optional[float]:
    """Host milliseconds of span `name` per env step of the window: its
    summed time over the window's records over the window's steps (the
    divisor of rollout.collect_ms_per_step); None where no record of the
    window holds the span."""
    picked = window_records(rec)
    steps = rec["window"]["steps"]
    if not picked or not steps:
        return None
    times = [r["spans"][name][1] for r in picked if name in r["spans"]]
    if not times:
        return None
    return sum(times) * 1e-6 / steps


def counter_per_iteration(rec, name: str) -> Optional[float]:
    """Counter `name` summed over the window's records, per iteration;
    None where no record of the window holds it."""
    picked = window_records(rec)
    if not picked:
        return None
    counts = [r["counters"][name] for r in picked if name in r["counters"]]
    if not counts:
        return None
    return sum(counts) / len(picked)


def setup_seconds() -> Optional[float]:
    """Seconds of the program's set-up spans (`setup.*`) not nested in
    another; None where the program recorded none."""
    got = program_records()
    if got is None or not got[1]["spans"]:
        return None
    return got[1]["top_ns"] * 1e-9
