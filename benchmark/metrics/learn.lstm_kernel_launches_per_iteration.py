"""learn.lstm_kernel_launches_per_iteration: launches of the recurrent
update's LSTM gate kernel forward (the program's counter `lstm_kernel`,
one per step of every minibatch's unroll through csrc/lstm.cu) per
training iteration of the window (benchmark/program_spans.py): steps x
epochs x minibatches where the whole unroll goes through the kernel.
Nothing where the program keeps no such counter."""

from benchmark import program_spans


def read(rec):
    return program_spans.counter_per_iteration(rec, "lstm_kernel")
