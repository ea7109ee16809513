"""The readings that the limits of `correct` are set from, for one cell
at its own size, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] --out <file.jsonl>

For every seed the program's first iterations are recorded and the
reference follows them (the lower readings). On the control seeds the
reference computed in TF32, the nearest precision below the
configurations' float32, is recorded in the program's place and followed
by the float32 reference (the control); on the fault seeds the reference
with each fault of benchmark/faults.py planted (the faults' readings). A
state left unchanged reads 1 by the measure of the change and is not
run. One JSON line per reading goes to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import cells, check, faults as faults_lib, reference
from .run import FIRST_STEPS, free_device


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def _session(entry, package, cell, seed, weights, prec, work, fault=None):
    """Build a session under `prec`, plant `fault`, run work(session);
    (its result, the weights, seconds to build, seconds of the work)."""
    t0 = time.perf_counter()
    with reference.precision(prec):
        session = entry.Session(package, cell["config_data"],
                                cell["traffic_data"], seed, "cuda",
                                weights=weights)
        if fault:
            faults_lib.plant(session, fault)
        built = time.perf_counter() - t0
        out = work(session)
    weights = session.weights
    session.close()
    del session
    free_device("cuda")
    return out, weights, [built, time.perf_counter() - t0 - built]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="half_batch,altered_reward")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = cells.workload(args.workload)
    entry = cells.entry(cell["config_data"])
    record = lambda s: s.first_steps(FIRST_STEPS)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        def side(seed, name, package, weights, prec, fault=None):
            rec, weights, t_rec = _session(entry, package, cell, seed,
                                           weights, prec, record, fault)
            ref, _, t_ref = _session(entry, entry.REFERENCE, cell, seed,
                                     weights, "float32",
                                     lambda s: s.follow(rec))
            nums = check.numbers(rec, ref)
            line = dict(cell=args.workload, seed=seed, side=name,
                        numbers=nums, loss=rec["loss"], ref_loss=ref["loss"],
                        grad=rec["grad"], ref_grad=ref["grad"],
                        change=rec["change"], ref_change=ref["change"],
                        seconds=[t_rec, t_ref])
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(dict(seed=seed, side=name, **nums,
                                  seconds=[t_rec, t_ref])), flush=True)
            return weights

        for seed in args.seeds:
            weights = side(seed, "program", entry.PROGRAM, None, "float32")
            if seed in args.control_seeds:
                side(seed, "control", entry.REFERENCE, weights, "tf32")
            if seed in args.fault_seeds:
                for fault in filter(None, args.faults.split(",")):
                    side(seed, fault, entry.REFERENCE, weights, "float32",
                         fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
