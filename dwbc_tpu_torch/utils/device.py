"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

from . import spans


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    `cuda` (the default) must exist: asking for it on a machine without a
    card raises instead of quietly running on the CPU. Selecting CUDA also
    turns TF32 off for matmuls and cuDNN convolutions, so the port's
    float32 sums (policy layers, the history encoder's Conv1d, the
    per-body wrench sums) stay full float32 like the JAX reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def on_card(x) -> bool:
    """Whether `x`, a tensor or a device, is on a CUDA device."""
    return (x.device if torch.is_tensor(x) else torch.device(x)).type == "cuda"


def host_sync(x, n: int = 1) -> None:
    """Count `n` points where the host waits for the card (the counter
    `host_sync` of utils/spans) when `x`, a tensor or a device, is on one:
    a read of a device value (`.item()`, `.tolist()`), or a copy from
    host memory that is not pinned (`torch.tensor(..., device=...)`, an
    index given as a Python list), which waits for the card's stream."""
    if on_card(x):
        spans.count("host_sync", n)
