"""Device measurement helpers shared by the benchmark harness
(dwbc_tpu_torch/bench.py) and chip_smoke.py: the card's published peaks
and its nvidia-smi identity, the contact law's bytes, operations and
bound, random contact-law inputs, and CUDA-graph timing of a call.

Everything that times or queries the card raises without one; nothing
here falls back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple, Optional

import numpy as np
import torch

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOPS = 67e12          # float32 outside the tensor cores
# float operations of the contact law per (sphere, env), counted from
# sim/contact.fused_terrain_law: plane evaluation 13, mass share 3,
# normal/tangent speeds and directional masses 57, warm-start split 16,
# normal force 8, friction 19, outputs and carry 24
LAW_FLOPS_PER_ELEM = 140
N_SETS = 3            # 3 x 41 MB of inputs at 84 x 8192 > the 50 MB L2
TIMED_LAUNCHES = 60
PLAIN_LAUNCHES = 12   # ~100 elementwise kernels each


class Card(NamedTuple):
    """One line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`, as printed and parsed."""

    smi: str
    name: str
    power_limit_w: Optional[float]


def card(index: int = 0) -> Card:
    """The name and power limit of GPU `index` from nvidia-smi (raises
    where nvidia-smi is missing or fails)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    line = out[index].strip()
    name, _, limit = line.rpartition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (IndexError, ValueError):   # "[N/A]" on cards without a limit
        watts = None
    return Card(smi=line, name=name.strip(), power_limit_w=watts)


def law_bytes(ng: int, n: int) -> int:
    """Bytes the contact law must move: 15 float32 (ng, N) input planes,
    friction, the per-sphere constants, 7 float32 output planes and the
    1-byte active mask."""
    return (15 * ng * n * 4 + n * 4 + ng * (9 * 4 + 4)
            + 7 * ng * n * 4 + ng * n)


def law_bound_ms(ng: int, n: int):
    """(bound in ms, "bytes" or "operations"): the least time the card
    could take for the law at ng spheres x n envs, the larger of its
    bytes over the HBM rate and its operations over the float32 rate."""
    byte_ms = law_bytes(ng, n) / HBM_BYTES_PER_S * 1e3
    flop_ms = LAW_FLOPS_PER_ELEM * ng * n / FP32_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations")


def random_scene(n, ng, nb, seed, device, sorted=True):
    """Contact-law inputs with about half the spheres in contact; the
    geom->body map sorted by body or in random order."""
    from ..sim.contact import ContactParams, GeomConst

    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = lambda a: torch.as_tensor(np.asarray(a, f32), device=device)
    gp = rng.normal(size=(3, ng, n)) * 0.3
    nx, ny = 0.3 * rng.normal(size=(2, ng, n))
    inv = 1.0 / np.sqrt(nx * nx + ny * ny + 1.0)
    w = rng.normal(size=(ng, 3, 3)) * 0.3
    m_solo = rng.uniform(0.3, 2.0, ng)
    W = w @ w.transpose(0, 2, 1) + np.eye(3) / m_solo[:, None, None]
    body = rng.integers(0, nb, ng)
    body = np.sort(body) if sorted else body
    gc = GeomConst(
        radius=t(rng.uniform(0.01, 0.05, ng)), m_solo=t(m_solo),
        m_body=t(rng.uniform(1.0, 8.0, ng)),
        w6=t([W[:, i, j] for i, j in
              ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]),
        geom_body=torch.as_tensor(body.astype(np.int32), device=device),
        nb=nb)
    cache = (t(0.1 * rng.normal(size=(ng, n))),
             t(np.stack([nx * inv, ny * inv, inv])),
             t(gp[0] - 0.01), t(gp[1] + 0.02))
    return (t(gp), t(rng.normal(size=(3, ng, n))), cache,
            t(np.abs(rng.normal(size=(3, ng, n))) * 5.0),
            t(np.linspace(0.4, 2.5, n)), gc, ContactParams(dt=0.005), 0.005)


def device_ms(fn, sets, launches):
    """Device time per call of fn(*args), `launches` calls rotating over
    the argument tuples in `sets`, captured in one CUDA graph and replayed
    after a warm-up replay: the calls run back to back on the card, with
    no Python between them, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def device_kernel_rows(events):
    """The device kernels of a profile's key_averages(), longest first: the
    aten:: rows repeat their kernels' time, and so do the annotation
    ranges that the optimizer puts on the device timeline."""
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    return sorted(rows, key=lambda e: -e.self_device_time_total)
