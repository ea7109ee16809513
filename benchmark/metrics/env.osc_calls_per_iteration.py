"""env.osc_calls_per_iteration: calls of widowGo1's OSC expert (the
program's counter `osc_target`, one per call) per training iteration of
the window (benchmark/program_spans.py). A guard like the kernels'
launch counts: it should read exactly one per env step, 40 at 40 steps;
a program that skipped the expert (say, while the supervision's weight
is 0) would leave out work that the reference does. Nothing where the
program keeps no such counter."""

from benchmark import program_spans


def read(rec):
    return program_spans.counter_per_iteration(rec, "osc_target")
