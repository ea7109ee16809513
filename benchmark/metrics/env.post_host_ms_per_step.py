"""env.post_host_ms_per_step: host milliseconds per env step of the
program's span `env.post`, everything of an env step after its physics
(bookkeeping, goal and commands, termination, rewards, stats, masked
reset, observations), summed over the window's iterations
(benchmark/program_spans.py). Host time, not device time: the span never
waits for the card."""

from benchmark import program_spans


def read(rec):
    return program_spans.span_ms_per_step(rec, "env.post")
