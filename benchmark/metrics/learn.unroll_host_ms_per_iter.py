"""learn.unroll_host_ms_per_iter: host milliseconds per training
iteration of the program's span `ppo.unroll`, the recurrent update's
re-unroll of each minibatch (the gather of its envs' first carry, the
model's unroll over the whole trajectory and the PPO loss), summed over
the window's iterations (benchmark/program_spans.py) and divided by
their number; None where no record of the window holds the span (the
feedforward update has none). Host time, not device time: the span
never waits for the card."""

from benchmark import program_spans

SPAN = "ppo.unroll"


def read(rec):
    picked = program_spans.window_records(rec)
    if not picked:
        return None
    times = [r["spans"][SPAN][1] for r in picked if SPAN in r["spans"]]
    if not times:
        return None
    return sum(times) * 1e-6 / len(picked)
