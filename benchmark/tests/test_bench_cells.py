"""BENCHMARK.json and the data files beside it: every cell, configuration,
traffic mix, limit and per-layer reader loads, and names what exists."""

import json
import os
import re

import pytest

from benchmark import cells, check
from benchmark.reference.utils import task_registry as ref_registry
from dwbc_tpu_torch.utils import task_registry

BENCH = cells.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_names_a_registered_task(name):
    cell = cells.workload(name, BENCH)
    config, traffic = cell["config_data"], cell["traffic_data"]
    assert config["name"] == cell["config"]
    assert config["task"] in task_registry.TASKS
    assert config["task"] in ref_registry.TASKS
    assert cells.entry(config).Session
    assert traffic["num_envs"] > 0 and traffic["num_steps_per_env"] > 0
    assert set(cell["limits"]) == set(check.NUMBERS)
    assert all(0 <= v < 1 for v in cell["limits"].values())
    assert cell["chips"] == 1
    reported = {m["name"] for m in cells.end_to_end(name, BENCH)}
    assert {"env_steps_per_s", "setup_s"} <= reported
    assert cells.per_layer(name, BENCH)


def test_every_file_named_exists_and_names_are_valid():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] == "env_steps_per_s"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configuration_files_state_the_published_sizes():
    for c in BENCH["configs"]:
        data = json.load(open(os.path.join(cells.ROOT, c["file"])))
        spec = task_registry.TASKS[data["task"]]
        assert data["published"] == {
            "num_envs": spec.default_num_envs,
            "num_steps_per_env": spec.num_steps_per_env}
        assert data["sizes"]["num_learning_epochs"] == \
            spec.ppo_cfg.num_learning_epochs
        assert data["sizes"]["num_mini_batches"] == \
            spec.ppo_cfg.num_mini_batches


def test_a_number_without_its_limit_is_not_correct():
    nums = {k: 0.0 for k in check.NUMBERS}
    limits = {k: 1e-3 for k in check.NUMBERS}
    assert check.judge(nums, limits)
    for k in check.NUMBERS:
        assert not check.judge(nums, {j: v for j, v in limits.items()
                                      if j != k})
        assert not check.judge({j: v for j, v in nums.items() if j != k},
                               limits)
        assert not check.judge({**nums, k: float("nan")}, limits)
        assert not check.judge({**nums, k: 2e-3}, limits)
