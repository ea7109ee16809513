"""What BENCHMARK.json and the data files beside it say about a cell.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); its limits are in `limits/<cell>.json` and
each per-layer metric's reader in `metrics/<metric>.py`. Adding any of
them is adding files and entries, never editing one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(name: str, bench=None) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic
    and limits loaded."""
    bench = bench or benchmark_json()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = dict(cells[name])
    cell["config_data"] = _json(HERE, "configs", cell["config"] + ".json")
    cell["traffic_data"] = _json(HERE, "traffic", cell["traffic"] + ".json")
    cell["limits"] = _json(HERE, "limits", name + ".json")
    return cell


def _applies(metric: dict, cell: str, bench: dict) -> bool:
    """A metric with `workloads` is reported in those cells; one without,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or any(m["name"] == moves and _applies(m, cell, bench)
                                for m in bench["end_to_end"])


def end_to_end(cell: str, bench=None):
    bench = bench or benchmark_json()
    return [m for m in bench["end_to_end"] if _applies(m, cell, bench)]


def per_layer(cell: str, bench=None):
    bench = bench or benchmark_json()
    return [m for m in bench["per_layer"] if _applies(m, cell, bench)]


def entry(config: dict):
    """The module that drives the configuration's training entry."""
    return importlib.import_module("benchmark.entries." + config["entry"])


def reader(metric: str):
    """metrics/<metric>.py, loaded by path (metric names hold dots)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
