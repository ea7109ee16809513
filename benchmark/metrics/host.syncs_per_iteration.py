"""host.syncs_per_iteration: points where the host waited for the card
(the program's counter `host_sync`: the runner's synchronisations, reads
of device values, copies from host memory that is not pinned) per
training iteration of the window (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(rec):
    return program_spans.counter_per_iteration(rec, "host_sync")
