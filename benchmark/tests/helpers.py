"""A cell of the benchmark at a size the CPU runs in seconds."""

import json
import os

from benchmark import cells


def tiny_cell(workload: str, num_envs: int = 16, steps: int = 4) -> dict:
    """`workload` with its configuration and limits, at num_envs x steps."""
    cell = cells.workload(workload)
    cell["traffic_data"] = {"num_envs": num_envs, "num_steps_per_env": steps}
    return cell


def config(name: str) -> dict:
    with open(os.path.join(cells.HERE, "configs", name + ".json")) as f:
        return json.load(f)
