"""The cell go1_flat_lstm-4096x24 on the CPU at a small size: the entry
`recurrent` (benchmark/entries/recurrent.py) against the reference's
padded-trajectory update comes out correct, every fault of its `plant`
does not, neither session loads JAX, and the three readers of the
recurrent update's spans read what they should."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells, faults, program_spans
from benchmark import run as run_lib
from benchmark.entries import recurrent
from benchmark.tests.helpers import tiny_cell

CELL = "go1_flat_lstm-4096x24"
SEED = 2 ** 31 + 9
READERS = {"learn.unroll_host_ms_per_iter": "ppo.unroll",
           "learn.backward_host_ms_per_iter": "ppo.backward",
           "learn.step_host_ms_per_iter": "ppo.step"}


def test_the_first_iterations_are_correct():
    torch.set_num_threads(2)
    result, nums = run_lib.run(tiny_cell(CELL), SEED, 0.2, False,
                               device="cpu")
    assert result["correct"] is True, nums
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", recurrent.FAULTS)
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    """Each fault planted by the entry's own `plant` under the timed path
    (benchmark/faults.py cannot reach the recurrent runner's update). A
    wrong learning rate shows in the parameters' change: the reference
    steps at the rates its own KL chose."""
    torch.set_num_threads(2)
    monkeypatch.setattr(faults, "plant", recurrent.plant)
    result, nums = run_lib.run(tiny_cell(CELL), SEED, 0.2, False,
                               device="cpu", faults=(fault,))
    assert result["correct"] is False, nums
    if fault == "unchanged":
        # a state left unchanged reads 1 by the measure of the change
        assert nums["change_gap"] == pytest.approx(1.0)
    if fault == "wrong_rate":
        assert nums["change_gap"] > cell_limit("change_gap")


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        recurrent.plant(None, "nothing")


def cell_limit(name):
    return cells.workload(CELL)["limits"][name]


SCRIPT = """
import json, sys
from benchmark import cells, run
from benchmark.entries import recurrent
cell = cells.workload("%s")
for pkg in (recurrent.PROGRAM, recurrent.REFERENCE):
    recurrent.Session(pkg, cell["config_data"],
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
    """A runner of other widths than the configuration states (the JAX
    package's 64-wide policy) fails at once."""
    config = dict(tiny_cell(CELL)["config_data"])
    config["sizes"] = dict(config["sizes"], rnn_hidden_size=64,
                           actor_hidden_dims=[64])
    with pytest.raises(ValueError, match="rnn_hidden_size"):
        recurrent.Session(recurrent.PROGRAM, config,
                          {"num_envs": 2, "num_steps_per_env": 2}, 1, "cpu")


def _record(it, collect_ns, profiled=False, learn=True):
    spans = {"runner.collect": [1, collect_ns], "runner.learn": [1, 9e8]}
    if learn:
        for k, name in enumerate(READERS.values()):
            spans[name] = [20, (k + 1) * 100_000_000]
    return {"it": it, "profiled": profiled, "spans": spans,
            "counters": {"host_sync": 23}}


def _rec(iterations=2, collect_s=5.0):
    return {"window": {"seconds": 6.0, "iterations": iterations,
                       "steps": 48, "collect_s": collect_s,
                       "learn_s": 1.8, "env_steps": 1, "flops": 1}}


@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_reads_its_span_per_iteration(name, monkeypatch):
    # set-up's iterations, a window of two, then a traced one
    history = [_record(0, 7e9), _record(1, 2e9), _record(2, 3e9),
               _record(3, 9e9, profiled=True)]
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: (history, {"spans": {}, "top_ns": 0}))
    k = list(READERS).index(name) + 1
    # k x 100 ms in each of the window's two records
    assert cells.reader(name)(_rec()) == pytest.approx(k * 100.0)


@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_without_its_span_reads_none(name, monkeypatch):
    history = [_record(0, 2e9, learn=False), _record(1, 3e9, learn=False)]
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: (history, {"spans": {}, "top_ns": 0}))
    assert cells.reader(name)(_rec()) is None
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert cells.reader(name)(_rec()) is None
