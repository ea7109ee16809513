"""sim.fk_kernel_launches_per_iteration: launches of the forward-kinematics
kernel (the program's counter `fk_kernel`, one per call of csrc/fk.cu) per
training iteration of the window (benchmark/program_spans.py): steps x
(substeps + 1), plus steps where the post-step reads the EE pose, where
every FK call goes through the kernel. Nothing where the program keeps no
such counter."""

from benchmark import program_spans


def read(rec):
    return program_spans.counter_per_iteration(rec, "fk_kernel")
