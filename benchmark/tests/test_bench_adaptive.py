"""The cell widowGo1_adaptive-5000x40 on the CPU at a small size: the entry
`adaptive` (benchmark/entries/adaptive.py) against the reference's
variant (reference/envs/widowgo1_adaptive.py) comes out correct, every
fault of its `plant` does not (the expert's target without gravity by
`env_gap`), the compared loss holds the unweighted arm torque loss,
neither session loads JAX, and the two readers of the OSC expert's span
and counter read what they should."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells, faults, program_spans
from benchmark import run as run_lib
from benchmark.entries import adaptive
from benchmark.tests.helpers import tiny_cell

CELL = "widowGo1_adaptive-5000x40"
SEED = 2 ** 31 + 9


def cell_limit(name):
    return cells.workload(CELL)["limits"][name]


def test_the_first_iterations_are_correct():
    torch.set_num_threads(2)
    result, nums = run_lib.run(tiny_cell(CELL), SEED, 0.2, False,
                               device="cpu")
    assert result["correct"] is True, nums
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", adaptive.FAULTS)
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(faults, "plant", adaptive.plant)
    result, nums = run_lib.run(tiny_cell(CELL), SEED, 0.2, False,
                               device="cpu", faults=(fault,))
    assert result["correct"] is False, nums
    if fault == "no_gravity":
        assert nums["env_gap"] > cell_limit("env_gap")


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        adaptive.plant(None, "nothing")


def test_each_learn_step_compares_its_arm_torque_loss():
    """After iteration 0 (DAgger: no torque branch) each PPO iteration
    records its loss and then its unweighted arm torque loss."""
    torch.set_num_threads(2)
    cell = tiny_cell(CELL, 4, 2)
    s = adaptive.Session(adaptive.PROGRAM, cell["config_data"],
                         cell["traffic_data"], SEED, "cpu")
    rec = s.first_steps(3)
    s.close()
    assert [it["dagger"] for it in rec["iterations"]] == [True, False, False]
    assert len(rec["loss"]) == 5
    assert rec["loss"][2] > 0 and rec["loss"][4] > 0


SCRIPT = """
import json, sys
from benchmark import cells, run
from benchmark.entries import adaptive
cell = cells.workload("%s")
for pkg in (adaptive.PROGRAM, adaptive.REFERENCE):
    adaptive.Session(pkg, cell["config_data"],
                     {"num_envs": 2, "num_steps_per_env": 2}, 1, "cpu")
print(json.dumps({"modules": sorted(sys.modules),
                  "forbidden": run.forbidden_modules()}))
""" % CELL


def test_neither_session_loads_jax():
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
           "HOME": cells.ROOT}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "dwbc_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "dwbc_tpu"}
    assert got["forbidden"] == []


def test_the_sizes_are_checked():
    """A runner of the plain widowGo1 (18 actions, no expert) against the
    variant's configuration fails at once."""
    config = dict(tiny_cell(CELL)["config_data"], task="widowGo1")
    with pytest.raises(ValueError, match="num_actions"):
        adaptive.Session(adaptive.PROGRAM, config,
                         {"num_envs": 2, "num_steps_per_env": 2}, 1, "cpu")


def _record(it, collect_ns, profiled=False, osc=True):
    spans = {"runner.collect": [1, collect_ns], "runner.learn": [1, 9e8]}
    counters = {"host_sync": 363}
    if osc:
        spans["env.osc"] = [40, 2_000_000_000]
        counters["osc_target"] = 40
    return {"it": it, "profiled": profiled, "spans": spans,
            "counters": counters}


def _rec(iterations=2, collect_s=5.0):
    return {"window": {"seconds": 6.0, "iterations": iterations,
                       "steps": 80, "collect_s": collect_s,
                       "learn_s": 1.8, "env_steps": 1, "flops": 1}}


def test_the_readers_read_the_span_and_the_counter(monkeypatch):
    # set-up's iterations, a window of two, then a traced one
    history = [_record(0, 7e9), _record(1, 2e9), _record(2, 3e9),
               _record(3, 9e9, profiled=True)]
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: (history, {"spans": {}, "top_ns": 0}))
    # 2 s in each of the window's two records over its 80 steps
    assert cells.reader("env.osc_host_ms_per_step")(_rec()) == \
        pytest.approx(50.0)
    assert cells.reader("env.osc_calls_per_iteration")(_rec()) == 40.0


@pytest.mark.parametrize("name", ["env.osc_host_ms_per_step",
                                  "env.osc_calls_per_iteration"])
def test_a_reader_without_the_expert_reads_none(name, monkeypatch):
    history = [_record(0, 2e9, osc=False), _record(1, 3e9, osc=False)]
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: (history, {"spans": {}, "top_ns": 0}))
    assert cells.reader(name)(_rec()) is None
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert cells.reader(name)(_rec()) is None
