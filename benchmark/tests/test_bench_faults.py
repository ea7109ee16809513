"""A run with its timed path broken underneath comes out not correct: each
fault of benchmark/faults.py planted in the program, the rest of the run
as on the card (the card's check skipped, the CPU at a small size)."""

import pytest
import torch

from benchmark import faults
from benchmark import run as run_lib
from benchmark.tests.helpers import tiny_cell


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["widowGo1-5000x40", "go1-4096x24"])
def test_a_planted_fault_is_not_correct(workload, fault):
    torch.set_num_threads(2)
    result, nums = run_lib.run(tiny_cell(workload), 2 ** 31 + 9, 0.2, False,
                               device="cpu", faults=(fault,))
    assert result["correct"] is False, nums
    if fault == "unchanged":
        # a state left unchanged reads 1 by the measure of the change
        assert nums["change_gap"] == pytest.approx(1.0)


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        faults.plant(None, "nothing")
