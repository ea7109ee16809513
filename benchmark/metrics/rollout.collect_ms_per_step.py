"""rollout.collect_ms_per_step: milliseconds of the collect per env step
over the window, from the runner's own collect timer (closed by a device
synchronisation), summed over the window's iterations."""


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return w["collect_s"] / w["steps"] * 1e3
