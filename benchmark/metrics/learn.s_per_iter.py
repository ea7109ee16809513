"""learn.s_per_iter: seconds of the learn step (GAE and the PPO or DAgger
update) per iteration over the window, from the runner's own learn timer
(closed by a device synchronisation)."""


def read(rec):
    w = rec["window"]
    if not w["iterations"]:
        return None
    return w["learn_s"] / w["iterations"]
