"""Snapshots of the program's state that the reference can take up.

The reference follows the program step by step (benchmark/check.py says
why): it is handed the program's env state before a step, and the
trajectories the program collected, as host copies. `snapshot` copies a
nest of dataclasses, named tuples, dicts, lists, tensors and torch
Generators to the host; `restore` rebuilds it on a device with the
reference's classes of the same module path and name, so that nothing of
the program is imported on the reference's side.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Iterator, Tuple

import torch

# the packages whose classes a snapshot names by their path under the root
ROOTS = ("benchmark.reference.", "dwbc_tpu_torch.")


class Gen:
    """A torch.Generator's device type and state."""

    def __init__(self, gen: torch.Generator):
        self.device_type = gen.device.type
        self.state = gen.get_state()


class Obj:
    """A dataclass or named tuple: its class's module path under the
    package root, its name, and its fields' snapshots."""

    def __init__(self, obj, fields):
        mod = type(obj).__module__
        root = next((r for r in ROOTS if mod.startswith(r)), None)
        if root is None:
            raise TypeError(f"{type(obj)} is of neither package")
        self.module = mod[len(root):]
        self.name = type(obj).__qualname__
        self.kind = "dataclass" if dataclasses.is_dataclass(obj) else "tuple"
        self.fields = fields


def snapshot(x) -> Any:
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return Gen(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return Obj(x, {f.name: snapshot(getattr(x, f.name))
                       for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return Obj(x, {k: snapshot(v) for k, v in zip(x._fields, x)})
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot(v) for v in x)
    return x


def restore(s, package: str, device) -> Any:
    """The snapshot rebuilt on `device` with `package`'s classes."""
    if torch.is_tensor(s):
        return s.to(device)
    if isinstance(s, Gen):
        gen = torch.Generator(device=torch.device(device))
        gen.set_state(s.state)
        return gen
    if isinstance(s, Obj):
        cls = getattr(importlib.import_module(f"{package}.{s.module}"),
                      s.name)
        fields = {k: restore(v, package, device) for k, v in s.fields.items()}
        return cls(**fields)
    if isinstance(s, dict):
        return {k: restore(v, package, device) for k, v in s.items()}
    if isinstance(s, (list, tuple)):
        return type(s)(restore(v, package, device) for v in s)
    return s


def leaves(x, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in a nest or a snapshot."""
    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, Obj):
        for k, v in x.fields.items():
            yield from leaves(v, f"{path}.{k}")
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}.{i}")
