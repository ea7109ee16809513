"""device.idle_share: the share (%) of the traced iteration's wall time
in which no operation ran on the card (one minus the union of the device
operations' intervals over the iteration)."""

from benchmark import trace


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    lo, hi = prof["window"]
    return (1.0 - trace.busy_ns(prof) / (hi - lo)) * 100.0
