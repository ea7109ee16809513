"""sim.aba_host_ms_per_step: host milliseconds per env step of the
program's span `sim.aba`, the joint-space extra torques and the
articulated-body algorithm's backward and forward passes of each physics
substep, summed over the window's iterations
(benchmark/program_spans.py). Host time, not device time: the span never
waits for the card."""

from benchmark import program_spans


def read(rec):
    return program_spans.span_ms_per_step(rec, "sim.aba")
