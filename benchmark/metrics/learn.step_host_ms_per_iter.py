"""learn.step_host_ms_per_iter: host milliseconds per training iteration
of the program's span `ppo.step`, each minibatch's step in the recurrent
update (the adaptive-KL read, which waits for the card, the learning
rate and the clipped Adam step), summed over the window's iterations
(benchmark/program_spans.py) and divided by their number; None where no
record of the window holds the span (the feedforward update has
none)."""

from benchmark import program_spans

SPAN = "ppo.step"


def read(rec):
    picked = program_spans.window_records(rec)
    if not picked:
        return None
    times = [r["spans"][SPAN][1] for r in picked if SPAN in r["spans"]]
    if not times:
        return None
    return sum(times) * 1e-6 / len(picked)
