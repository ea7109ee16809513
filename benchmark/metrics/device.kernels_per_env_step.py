"""device.kernels_per_env_step: device kernels launched in the traced
iteration (collect and learn step) per env step of it. A host-bound
program is paced by this count."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not rec["profile_steps"]:
        return None
    kernels = sum(1 for d in prof["device"] if d[3] == "kernel")
    return kernels / rec["profile_steps"]
