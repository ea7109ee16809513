"""The control of `correct` on the card: the reference computed in TF32,
the nearest precision below the configurations' float32, recorded in the
program's place at each cell's own size and followed by the float32
reference, fails the cell's limits."""

import pytest

from benchmark import cells, check
from benchmark.calibrate import _session
from benchmark.run import FIRST_STEPS

CELLS = [w["name"] for w in cells.benchmark_json()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_reference_is_not_correct(cuda, workload):
    cell = cells.workload(workload)
    entry = cells.entry(cell["config_data"])
    seed = 20240 + len(workload)
    rec, weights, _ = _session(entry, entry.REFERENCE, cell, seed, None,
                               "tf32", lambda s: s.first_steps(FIRST_STEPS))
    ref, _, _ = _session(entry, entry.REFERENCE, cell, seed, weights,
                         "float32", lambda s: s.follow(rec))
    nums = check.numbers(rec, ref)
    print(workload, nums)
    assert not check.judge(nums, cell["limits"]), nums
