"""Device selection shared by every entry point of the reference.

Unlike the port's, it leaves TF32 alone: the caller sets the matmul
precision (benchmark/reference/__init__.py, `precision`)."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on; `cuda` must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
