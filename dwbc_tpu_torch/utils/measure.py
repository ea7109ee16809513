"""Device measurement helpers of chip_smoke.py: the card's published
peaks and its nvidia-smi identity, the contact law's bytes, operations
and bound, random contact-law inputs, the ABA op's random inputs and
bytes (shared with tests/test_torch_aba_kernel.py), the FK and the LSTM
kernels' bytes, and CUDA-graph timing of a call; and the comparison of a
learning curve with the JAX package's committed runs (`compare_curves`,
`CURVES`), which reads only their metrics.jsonl.

Everything that times or queries the card raises without one; nothing
here falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import subprocess
from typing import Dict, NamedTuple, Optional, Sequence

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


def card() -> str:
    """The first GPU's line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` (raises where nvidia-smi is missing or
    fails)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


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


# every tree a task builds its substep from: widowGo1 (21 bodies, two
# prismatic sibling fingers under body 18) and the legged robots (13)
ABA_TREES = ("widowGo1", "go1", "a1", "anymal_b", "anymal_c", "cassie")


def aba_model(name):
    """(RobotModel, i_eff) of an ABA_TREES tree as its task loads it, with
    the joints' effective inertias at the reference pose."""
    from ..core import urdf
    from ..envs import legged_config
    from ..sim import dynamics

    if name == "widowGo1":
        m = urdf.load_urdf(urdf.WIDOW_GO1_URDF,
                           dof_order=urdf.WIDOW_GO1_DOF_ORDER, armature=0.01)
    else:
        cfg = getattr(legged_config, f"{name}_rough")().asset
        m = urdf.load_urdf(cfg.file, dof_order=cfg.dof_order,
                           armature=cfg.armature)
    q_ref = np.zeros(m.nq, np.float32)
    q_ref[6] = 1.0
    M = dynamics.crba(m, dynamics.default_inertial(m, "cpu"),
                      torch.as_tensor(q_ref))
    return m, torch.diagonal(M)[6:]


def random_aba_state(m, n, seed, past_limits=True):
    """Random inputs of the ABA op for model m at n envs, as numpy: q, qd,
    tau, mass, com, inertia, bF, bN ((3, nb, n) each). Base poses and
    velocities, joints up to 0.3 rad past their limits (or 5% inside
    them), every 7th env's joints at rest and every 7th from the 3rd
    20x faster, per-env masses and inertias scaled by 0.8-1.2, nonzero
    contact wrenches on every body."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lo = np.maximum(m.dof_lower, -3.0)
    hi = np.minimum(m.dof_upper, 3.0)
    pad = 0.3 if past_limits else -0.05 * (hi - lo)
    q = np.zeros((n, m.nq), f32)
    q[:, :3] = rng.normal(0.0, 1.0, (n, 3))
    quat = rng.normal(size=(n, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(lo - pad, hi + pad, (n, m.nj))
    qd = rng.normal(0.0, 1.0, (n, m.nv)).astype(f32)
    qd[::7, 6:] = 0.0                         # joints at rest
    qd[3::7, 6:] *= 20.0                      # and fast
    scale = rng.uniform(0.8, 1.2, (n, m.nb)).astype(f32)
    return dict(
        q=q, qd=qd, tau=rng.normal(0.0, 10.0, (n, m.nj)).astype(f32),
        mass=np.asarray(m.mass, f32) * scale,
        com=np.tile(np.asarray(m.com, f32), (n, 1, 1)),
        inertia=np.asarray(m.inertia, f32) * scale[..., None, None],
        bF=rng.normal(0.0, 20.0, (3, m.nb, n)).astype(f32),
        bN=rng.normal(0.0, 2.0, (3, m.nb, n)).astype(f32))


def aba_args(m, s, device):
    """The ABA op's arguments after its TreeConst for state s of
    random_aba_state on `device`, the stacks from sim/dynamics' FK:
    (args, kinematics, the state's tensors)."""
    from ..core import spatial
    from ..sim import dynamics

    t = {k: torch.as_tensor(v, device=device) for k, v in s.items()}
    kin = dynamics.fk(m, t["q"], t["qd"])
    IA_body = spatial.spatial_inertia(t["mass"], t["com"], t["inertia"])
    return (t["q"], t["qd"], t["tau"], kin.rot.transpose(0, 1).contiguous(),
            kin.vel.transpose(0, 1).contiguous(), IA_body, t["mass"],
            t["com"], t["bF"], t["bN"]), kin, t


def aba_bytes(args, table) -> int:
    """Bytes the ABA kernel must move for the op's arguments `args` (after
    its TreeConst): every input, of the symmetric (N, nb, 6, 6) spatial
    inertias only the upper triangles, the tree table, and the (N, nb - 1)
    joint and (N, 6) base accelerations it writes."""
    q, IA_body = args[0], args[5]
    n, nb = IA_body.shape[:2]
    floats = (sum(t.numel() for i, t in enumerate(args) if i != 5)
              + 21 * nb * n + table.numel() + n * (nb - 1 + 6))
    return 4 * floats


def fk_bytes(nb: int, n: int, with_qd: bool) -> int:
    """Bytes the FK kernel must move at nb bodies x n envs: q (n, nb + 6),
    the tree table it copies (nb, TABLE_W), and the (nb, n) stacks it
    writes, rotations and positions; with qd, also qd (n, nb + 5) and the
    velocities."""
    from ..sim.tree import TABLE_W

    floats = n * (nb + 6) + nb * TABLE_W + nb * n * (9 + 3)
    if with_qd:
        floats += n * (nb + 5) + nb * n * 6
    return 4 * floats


def lstm_bytes(m: int, b: int, h: int, backward: bool) -> int:
    """Bytes one step of the LSTM gate kernel (csrc/lstm.cu) must move at
    m memories x b rows x h units, at a step with a next one: forward 17
    floats an element (reads 4 input projections, 4 recurrent products and
    c_{t-1}; writes 4 gates, c_t, h_t and the masked carry pair), backward
    14 (reads 4 gates, c_t, c_{t-1}, the output's gradient and the next
    carry's two gradients; writes 4 gate gradients and c_{t-1}'s); and
    keep, b floats."""
    return 4 * (m * b * h * (14 if backward else 17) + b)


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


# ---------------------------------------------------------------------------
# learning curves against the JAX package's runs


TERM_KEYS = ("Episode/term_roll", "Episode/term_pitch", "Episode/term_z",
             "Episode/term_timeout", "Episode/term_bad")
TERMS = "Episode/term_*"   # the key of the leading-channel band
LEN = "Train/mean_episode_length"
REW = "Train/mean_reward"
LEVEL = "Episode/terrain_level"
LEG_STD = "Policy/leg_mean_noise_std"
ARM_STD = "Policy/arm_mean_noise_std"
TORQUES = "Loss/arm_torques_loss"


class Band(NamedTuple):
    """How the port's value at a checkpoint is held against the JAX runs'
    values there (their min and max):
      scale     [lo x min, hi x max], of |values| with `magnitude`;
      offset    [min - lo, max + lo];
      at_least  [lo, inf), whatever the JAX runs logged;
      leading   (key TERMS) the channel of TERM_KEYS with the largest share
                must lead in every JAX run too, and its share lie in
                [min - lo, max + lo] of theirs."""

    kind: str
    lo: float
    hi: float = math.inf
    magnitude: bool = False


def read_curve(path) -> Dict[int, dict]:
    """A metrics.jsonl as {iteration: row}, the first line of each
    iteration kept (a resumed JAX run logs some iterations twice)."""
    rows = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                rows.setdefault(int(row["it"]), row)
    return rows


def _leading(row):
    """(channel, share) of the largest termination share of a row."""
    return max(((k, row[k]) for k in TERM_KEYS), key=lambda kv: kv[1])


def compare_curves(port_rows, jax_runs: Sequence[str],
                   checkpoints: Sequence[int], keys: Dict[str, Band]):
    """The port's curve (its metrics.jsonl rows) against the JAX runs'
    metrics.jsonl files (paths) at each checkpoint and key. One dict per
    (checkpoint, key): it, key, port, jax (one value per run), band [lo,
    hi], ok, and `missing` (where the port or a run lacks the iteration
    or the key: reported, never skipped; ok is then False)."""
    port = {}
    for row in port_rows:
        port.setdefault(int(row["it"]), row)
    runs = {path: read_curve(path) for path in jax_runs}
    out = []
    for it in checkpoints:
        for key, band in keys.items():
            need = TERM_KEYS if band.kind == "leading" else (key,)
            missing = []
            if it not in port or any(k not in port[it] for k in need):
                missing.append("port")
            missing += [path for path, rows in runs.items()
                        if it not in rows or any(k not in rows[it]
                                                 for k in need)]
            entry = dict(it=it, key=key, kind=band.kind, port=None,
                         jax=None, band=None, ok=False, missing=missing)
            out.append(entry)
            if missing:
                continue
            jrows = [rows[it] for rows in runs.values()]
            if band.kind == "leading":
                channel, value = _leading(port[it])
                leads = sorted({_leading(r)[0] for r in jrows})
                jvals = [r[channel] for r in jrows]
                lo, hi = min(jvals) - band.lo, max(jvals) + band.lo
                entry.update(port=value, jax=jvals, band=[lo, hi],
                             channel=channel, jax_channels=leads,
                             ok=bool(leads == [channel]
                                     and lo <= value <= hi))
                continue
            value = port[it][key]
            jvals = [r[key] for r in jrows]
            if band.kind == "at_least":
                lo, hi = band.lo, band.hi
            elif band.kind == "offset":
                lo, hi = min(jvals) - band.lo, max(jvals) + band.lo
            elif band.kind == "scale":
                mags = [abs(v) for v in jvals] if band.magnitude else jvals
                lo, hi = band.lo * min(mags), band.hi * max(mags)
            else:
                raise ValueError(f"unknown band kind {band.kind!r}")
            checked = abs(value) if band.magnitude else value
            entry.update(port=value, jax=jvals, band=[lo, hi],
                         ok=bool(lo <= checked <= hi))
    return out


# The JAX runs and bands each task's curve is held to (paths from the
# repository's root): a list of (checkpoints, {key: Band}). Keyed by
# task, and by `<task>@ts<weight>` for a torque-supervision weight other
# than the default (`curve_key`).
_SCALE = Band("scale", 0.8, 1.25)
_WIDE = Band("scale", 0.67, 1.5)
CURVES = {
    "widowGo1": dict(
        runs=tuple(f"logs/rough_widowGo1/{r}/metrics.jsonl" for r in
                   ("r4_widow_fresh", "r5_widow_marathon", "r5_flag2k")),
        checks=[((10, 20, 30, 50, 100), {
            LEN: _SCALE, REW: Band("scale", 0.8, 1.25, magnitude=True),
            TERMS: Band("leading", 0.10),
            LEG_STD: Band("offset", 0.05)})]),
    "widowGo1_flat": dict(
        runs=("logs/flat_widowGo1/r5_widowflat/metrics.jsonl",),
        checks=[((10, 50, 100), {
            LEN: _SCALE, "Episode/term_z": Band("at_least", 0.95)})]),
    "go1_flat_lstm": dict(
        runs=("logs/flat_go1_lstm/r5_lstm/metrics.jsonl",),
        checks=[((200, 300), {REW: Band("scale", 0.5, 2.0)}),
                ((300,), {LEN: Band("at_least", 900.0)})]),
    "go1_flat": dict(
        runs=("logs/flat_go1/r2_go1flat_v2/metrics.jsonl",),
        checks=[((200, 300), {REW: Band("scale", 0.5, 2.0)})]),
    # the curriculum first demotes everyone, the stairs families first
    "go1": dict(
        runs=("logs/rough_go1/r5_go1_famdiag/metrics.jsonl",),
        checks=[((10, 20), {LEVEL: _WIDE}),
                ((100,), {LEVEL: Band("offset", 0.10)}),
                ((200, 300), {LEVEL: Band("offset", 0.05)}),
                ((20,), {"Episode/metric_level_slope": Band("offset", 0.25),
                         "Episode/metric_level_stairs_down":
                             Band("offset", 0.25)}),
                ((10, 20, 50, 100), {
                    REW: Band("scale", 0.67, 1.5, magnitude=True)}),
                ((10,), {LEN: _WIDE}),
                ((50, 100, 200, 300), {LEG_STD: Band("offset", 0.05)})]),
    # torque supervision at weight 0, the reference's default: the arm's
    # std falls
    "widowGo1_adaptive": dict(
        runs=("logs/rough_widowGo1_adaptive/r5_adaptive_w0/metrics.jsonl",),
        checks=[((10, 20, 30, 50, 100, 200), {
            LEN: _SCALE, REW: Band("scale", 0.8, 1.25, magnitude=True),
            TERMS: Band("leading", 0.10), LEG_STD: Band("offset", 0.05)}),
                ((50, 100, 200), {ARM_STD: Band("offset", 0.05)}),
                ((10, 30, 50), {TORQUES: _SCALE})]),
    # the same at weight 1 (--ts_weight 1): the arm's std rises
    "widowGo1_adaptive@ts1": dict(
        runs=("logs/rough_widowGo1_adaptive/r5_adaptive_tsw1/"
              "metrics.jsonl",),
        checks=[((10, 30, 50), {TORQUES: _SCALE}),
                ((50, 100, 200), {ARM_STD: Band("offset", 0.05)}),
                ((10, 50, 100, 200), {LEN: _SCALE})]),
}


def curve_key(task: str, ts_weight: Optional[float] = None) -> str:
    """The key of CURVES that a learning curve of `task` trained with
    `--ts_weight ts_weight` is held to: the task's own entry at the
    default weight (None or 0), `<task>@ts<weight>` otherwise. Raises
    KeyError where CURVES has no such entry; never falls back to
    another."""
    key = task if ts_weight in (None, 0.0) else f"{task}@ts{ts_weight:g}"
    if key not in CURVES:
        raise KeyError(f"no learning curve for task {task!r} at ts_weight "
                       f"{ts_weight!r} (CURVES holds {sorted(CURVES)})")
    return key
