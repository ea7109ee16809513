"""env.osc_host_ms_per_step: host milliseconds per env step of the
program's span `env.osc`, widowGo1's OSC expert (the target torques of
the torque supervision, computed before each step's physics), summed
over the window's iterations (benchmark/program_spans.py). Host time,
not device time: the span never waits for the card, except at the
expert's own blocking copy, which `host.syncs_per_iteration` counts.
Nothing where no record of the window holds the span (a program without
it, or a task without the expert)."""

from benchmark import program_spans


def read(rec):
    return program_spans.span_ms_per_step(rec, "env.osc")
