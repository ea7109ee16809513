"""The yardstick: the card's published peaks, the operation and byte
counts that rooflines and `train_mfu` divide by, and interval arithmetic
for the device's busy time.

Copied from the port's measurement code (dwbc_tpu_torch/utils/measure.py,
dwbc_tpu_torch/bench.py) so that a change to the program cannot move it.
"""

from __future__ import annotations

import subprocess
from typing import Iterable, List, Optional, Sequence, Tuple

from torch import nn

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOPS = 67e12          # float32 outside the tensor cores
# float operations of the contact law per (sphere, env), counted from
# sim/contact.fused_terrain_law: plane evaluation 13, mass share 3,
# normal/tangent speeds and directional masses 57, warm-start split 16,
# normal force 8, friction 19, outputs and carry 24
LAW_FLOPS_PER_ELEM = 140


def law_bytes(ng: int, n: int) -> int:
    """Bytes the contact law must move at ng spheres x n envs: 15 float32
    (ng, n) input planes, friction, the per-sphere constants, 7 float32
    output planes and the 1-byte active mask."""
    return (15 * ng * n * 4 + n * 4 + ng * (9 * 4 + 4)
            + 7 * ng * n * 4 + ng * n)


def law_bound_ms(ng: int, n: int) -> Tuple[float, str]:
    """(bound in ms, "bytes" or "operations"): the least time the card
    could take for one launch of the law, the larger of its bytes over
    the HBM rate and its operations over the float32 rate."""
    byte_ms = law_bytes(ng, n) / HBM_BYTES_PER_S * 1e3
    flop_ms = LAW_FLOPS_PER_ELEM * ng * n / FP32_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations")


def forward_flops(model: nn.Module) -> int:
    """Operations of one row through the policy's forward pass, which a
    collect step runs once per env: 2 x in x out for every Linear on the
    way. The history encoder of the dual-head ActorCritic runs only in
    DAgger iterations and is not counted. A count from the layer widths,
    independent of how the program computes them."""
    actor = getattr(model, "actor", None)
    hist = getattr(actor, "history_encoder", None)
    skip = {id(m) for m in hist.modules()} if hist is not None else set()
    return sum(2 * m.in_features * m.out_features for m in model.modules()
               if isinstance(m, nn.Linear) and id(m) not in skip)


def flops_per_iteration(model: nn.Module, num_envs: int, steps: int,
                        epochs: int) -> int:
    """A PPO iteration's policy operations: one forward per env per
    collect step, and forward + backward (3 forwards) per trajectory row
    in each learning epoch."""
    return forward_flops(model) * num_envs * steps * (1 + 3 * epochs)


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def card_name_and_limit(index: int = 0) -> Optional[str]:
    """`name, power.limit` of GPU `index` as nvidia-smi prints it, or None
    where nvidia-smi cannot be asked."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[index].strip() if index < len(lines) else None
