"""train_mfu: the policy's operations over the window (counted from the
layer widths, benchmark/yardstick.py) per second of the window's wall
time, as a share (%) of the card's float32 peak without tensor cores
(the program runs float32 with TF32 off)."""

from benchmark import yardstick


def read(rec):
    w = rec["window"]
    if not w["seconds"] or not w["flops"]:
        return None
    return w["flops"] / w["seconds"] / yardstick.FP32_FLOPS * 100.0
