"""sim.aba_kernel_launches_per_iteration: launches of the articulated-body
kernel (the program's counter `aba_kernel`, one per physics substep that
runs csrc/aba.cu) per training iteration of the window
(benchmark/program_spans.py): steps x substeps where every substep goes
through the kernel. Nothing where the program keeps no such counter."""

from benchmark import program_spans


def read(rec):
    return program_spans.counter_per_iteration(rec, "aba_kernel")
