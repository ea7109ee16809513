"""One run of one cell of the benchmark of dwbc_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the program's runner for the cell with weights made from
the seed on the card, and runs its first iterations through the window's
own call (every shape the cell uses, DAgger's iteration 0 included),
recording what `correct` compares. The window then runs whole training
iterations until --seconds are spent, the card synchronised at both ends.
With --trace 1 the same window gives the timing metrics, then one more
iteration runs under the profiler with the card's activity alone, for
the device metrics, and a last one with the host's operator calls and
spans as well, for the breakdown (benchmark/trace.py). Then the
program is freed and the plain reference, built from the same seed and
weights, follows the recorded first iterations step by step
(benchmark/check.py).

The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import cells  # noqa: E402

CACHE = os.path.join(cells.HERE, ".cache")
# iterations that set-up runs and the reference follows
FIRST_STEPS = 3
# modules that nothing of a run may load, by top-level name or whole name
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "optax", "dwbc_tpu")
FORBIDDEN_WHOLE = ("dwbc_tpu_torch.bench",)


def forbidden_modules():
    tops = {m.split(".")[0] for m in sys.modules}
    return (sorted(tops & set(FORBIDDEN_TOP))
            + sorted(set(sys.modules) & set(FORBIDDEN_WHOLE)))


def _finite(x):
    """x where it is a finite number, else None (JSON has no inf or NaN)."""
    return x if isinstance(x, float) and math.isfinite(x) else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def free_device(device):
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        faults=()):
    """The run's result (without `checks`) and the numbers compared."""
    import torch

    from . import check, faults as faults_lib, reference
    from . import trace as trace_lib

    config, traffic = cell["config_data"], cell["traffic_data"]
    entry = cells.entry(config)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    session = entry.Session(entry.PROGRAM, config, traffic, seed, device)
    for fault in faults:
        faults_lib.plant(session, fault)
    prog = session.first_steps(FIRST_STEPS)
    weights = session.weights
    sync()
    setup_s = time.perf_counter() - _T0

    per_iter = session.env_steps_per_iteration()
    bad = torch.zeros((), dtype=torch.int64, device=device)
    iters, collect_s, learn_s, ends = 0, 0.0, 0.0, []
    sync()
    t0 = time.perf_counter()
    while True:
        session.iterate()
        bad += session.nonfinite_rows()
        c, l = session.timers()
        collect_s, learn_s, iters = collect_s + c, learn_s + l, iters + 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    print("window: iterations end at (s) "
          + " ".join(f"{t:.3f}" for t in ends), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    rec = {"window": {"seconds": wall, "iterations": iters,
                      "env_steps": per_iter * iters,
                      "steps": session.steps * iters,
                      "collect_s": collect_s, "learn_s": learn_s,
                      "flops": session.flops_per_iteration() * iters},
           "contact_shape": session.contact_shape(),
           "profile": None, "profile_steps": 0}
    device_entry = {"platform": "gpu" if on_card else "cpu",
                    "kind": (torch.cuda.get_device_name() if on_card
                             else "cpu"),
                    "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": per_iter * iters,
              "failed": int(bad)}
    if trace:
        prof = trace_lib.device_iteration(session)
        full = trace_lib.host_iteration(session)
        rec["profile"], rec["profile_steps"] = prof, session.steps
        lo, hi = prof["window"]
        device_entry["busy_s"] = trace_lib.busy_ns(prof) * 1e-9
        device_entry["window_s"] = (hi - lo) * 1e-9
        metrics = {}
        for m in cells.per_layer(cell["name"]):
            value = cells.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = trace_lib.breakdown(full)
        walls = {"window_iteration_s": wall / iters,
                 "device_traced_s": prof["wall_s"],
                 "host_traced_s": full["wall_s"]}
        print("traced iterations' wall (s): "
              + " ".join(f"{k} {v:.4f}" for k, v in walls.items()),
              file=sys.stderr)
        trace_lib.write(cell["name"], prof, full, {
            "cell": cell["name"], "seed": seed, "window": rec["window"],
            "profile_steps": session.steps, "walls": walls,
            "contact_shape": list(rec["contact_shape"])})
    else:
        metrics = {"env_steps_per_s": {"value": per_iter * iters / wall,
                                       "unit": "env-steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    session.close()
    del session
    free_device(device)

    with reference.precision("float32"):
        ref_session = entry.Session(entry.REFERENCE, config, traffic, seed,
                                    device, weights=weights)
        ref = ref_session.follow(prog)
    ref_session.close()
    del ref_session
    free_device(device)

    nums = check.numbers(prog, ref)
    result.update(correct=check.judge(nums, cell["limits"]), metrics=metrics,
                  device=device_entry)
    return result, nums


def main(argv=None) -> int:
    args = parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    cell = cells.workload(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    # one intra-op thread: the window is paced by the host's launches, and
    # idle worker threads only contend with it for the host's cores
    torch.set_num_threads(1)
    from . import check, yardstick
    result, nums = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules that a run may not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    result["card"] = yardstick.card_name_and_limit()
    result["checks"] = {k: {"value": _finite(nums.get(k)),
                            "limit": cell["limits"].get(k)}
                        for k in check.NUMBERS}
    print(json.dumps(result), flush=True)
    print("\n".join(check.lines(nums, cell["limits"])), file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
