"""contact_law_kernel_roofline: the contact law's bound at the cell's
shape (bytes over the HBM rate, benchmark/yardstick.py) over the mean
device time of one launch of `contact_law_kernel` in the traced
iteration, as a share (%). Nothing where the kernel did not run."""

from benchmark import yardstick


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    times = [e - s for name, s, e, kind in prof["device"]
             if kind == "kernel" and "contact_law_kernel" in name]
    if not times:
        return None
    bound_ms, _ = yardstick.law_bound_ms(*rec["contact_shape"])
    mean_ms = sum(times) / len(times) * 1e-6
    return bound_ms / mean_ms * 100.0
