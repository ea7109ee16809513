"""Smoke run of the PyTorch/CUDA port (dwbc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also writes per-kernel profiles of
                                     # one env step and of the learn steps
                                     # to chiprun_out/
    python3 chip_smoke.py --learning-curve 301   # go1_flat training only
    python3 chip_smoke.py --learning-curve 101 --task widowGo1 \
        --num_envs 8192 --seed 1 --spawn_relative  # one task's curve,
                                     # train CLI flags after --task T,
                                     # held to the JAX runs (learning_curve)
    python3 chip_smoke.py --learning-curve 201 --task widowGo1_adaptive \
        --num_envs 2048 --seed 1 --ts_weight 1   # held to the weight-1 run

Phases, each of which raises on failure (exit code != 0):
  1. the card's name and power limit (nvidia-smi);
  2. build: compiles the contact, the ABA and the FK kernels from
     dwbc_tpu_torch/csrc with nvcc and logs ptxas's register and spill
     report; the ABA and the FK kernels must not spill;
  3. kernels: the CUDA contact kernel against its plain PyTorch version on
     the card (`active` exact, the forces within the parity tolerances) at
     KERNEL_SHAPES: widowGo1's 84 spheres on 21 bodies x 8192 envs (the
     slice and train phases' shape), x 1024 envs (the variant phase's), a
     ragged 8192 + 77, one env, the kernel's limits (128 spheres, 32
     bodies), a geom->body map in random order, and the legged robots'
     shapes at 4096 envs on 13 bodies: 92 (go1), 76 (a1), 28 (anymal_b),
     22 (anymal_c) and 5 (cassie) spheres, play's 5 envs, one rank's
     2048 go1 envs, and the learning curves' 84 x 21 x 4096
     (widowGo1_flat) and 84 x 21 x 2048 (widowGo1_adaptive). Per shape:
     its device time per launch (a CUDA graph of TIMED_LAUNCHES launches
     rotating over N_SETS input sets, so that at 84 x 8192 each launch
     reads its inputs from HBM and not from the 50 MB L2), achieved GB/s
     and share of the bound, the plain version's time and the wrapper's
     host time; beside them two yardsticks: the kernel on one input set
     (L2 warm) and one device copy that moves the same bytes (`copy_`,
     not a port of the law);
  3b. aba kernel: ops/aba_kernel.aba against sim/aba.fused_aba on the same
     card tensors at ABA_SHAPES (widowGo1's 21 bodies at 5000 and 8192
     envs, go1's 13 at 4096, both at play's 5), random states with joints
     past their limits, resting and fast joints, contact wrenches on every
     body, and one env whose base block falls under the 1e-6 pivot floor:
     every output finite and within relative 1e-5, one launch counted per
     call. Per shape: its device time per launch (CUDA graph over N_SETS
     input sets), the plain version's device time and both host times per
     call, and the byte bound of those inputs at 3.35 TB/s;
  3c. fk kernel: ops/fk_kernel.fk against sim/fk.fused_fk on the same card
     tensors at ABA_SHAPES, with qd and without, random states as in 3b:
     rotations, positions and velocities finite and within relative 1e-5,
     one launch counted per call, and the count of entries that differ
     from the eager version's at all (0 where the kernel's pinned rounding
     order is cuBLAS's); per shape its device time per launch,
     the plain version's, both host times and the byte bound
     (measure.fk_bytes) at 3.35 TB/s;
  3d. lstm kernels: ops/lstm_kernel.lstm_sequence (the forward and the
     backward gate kernels of csrc/lstm.cu) against the same op with its
     plain gate steps on the same card tensors at LSTM_SHAPES (a
     minibatch of go1_flat_lstm's unroll, 2 memories x 24 steps x 1024
     rows x 512 units, and 2 x 5 x 33 x 64), resets on ~5% of the rows,
     forward and backward: outputs and gradients finite and within
     relative 1e-5, T launches of each kernel a sequence; per shape each
     kernel's device time for one step (CUDA graph over N_SETS buffer
     sets) beside the plain step's and its byte bound
     (measure.lstm_bytes), and the whole sequence's forward and backward;
  4. step check: one widowGo1 env step on the card (the kernel) against
     the same step on the CPU (the plain law), 64 envs, same state;
  5. slice: make_env("widowGo1", 8192 envs) on the full Perlin terrain, an
     ActorCritic on the card, and two 40-step Rollout.collect calls
     (history encoder on, as training's iteration 0 runs, then off). Each
     must launch the contact kernel exactly 160 times (40 steps x 4
     substeps) and give finite observations, rewards and state. With
     --profile, the contact kernel's device time per launch inside the
     env step, beside its isolated time;
  6. train: make_runner("widowGo1", 8192 envs) and three training
     iterations through OnPolicyRunner.learn (iteration 0 is the DAgger
     phase, 1 and 2 the PPO update). Checks: 480 contact-kernel launches;
     every parameter and every logged value finite; iteration 0 moved
     nothing outside the history encoder; std at or above min_policy_std
     after iteration 1; counter == 3; metrics.jsonl has 3 lines with
     Perf/total_fps. Prints collect seconds, learn seconds and
     Perf/total_fps per iteration. Then save, a second runner, load, equal
     parameters and counter. With --profile, a torch.profiler table of
     one DAgger and one PPO learn step;
  7. update check: one `update` and one `update_dagger` on the card
     against the same calls on the CPU from the same state, trajectory
     (T = 8, N = 64) and permutation; parameters within rtol 1e-4 /
     atol 1e-5;
  7b. bf16 update check: phase 7's `update` (same state, trajectory and
     permutation) with the bf16 observation store on (ppo._BF16_OBS,
     what DWBC_BF16_OBS=1 sets), card against CPU within phase 7's
     tolerances; the store must move the result from the float32
     update's by more than 1e-6;
  8. variant: make_runner("widowGo1_adaptive", 1024 envs), two
     iterations: OSC targets finite and not all zero in the trajectory,
     Loss/arm_torques_loss finite and positive, 320 launches; and one
     `_osc_target` on the card against the CPU at 64 envs, rtol 1e-3 /
     atol 1e-3. With --profile, the same two iterations once more at
     8192 envs with the peak device memory, and the wall time of one
     `_osc_target` call at both widths.
  9. legged: make_runner("go1", 4096 envs) on the curriculum grid terrain
     (187 measured heights, 235-wide observation), three iterations of 24
     steps through OnPolicyRunner.learn with the MLP policy: 288 launches;
     finite observations, rewards, state and parameters; every parameter
     moved; 3 lines of metrics.jsonl with Episode/terrain_level; a
     checkpoint round trip; one env step that must not wait for the host
     (torch.cuda.set_sync_debug_mode). Prints collect seconds, learn
     seconds and Perf/total_fps per iteration. With --profile, a
     torch.profiler table of one go1 env step;
 10. legged step check: one go1 step (grid terrain, heights) on the card
     against the same step on the CPU, 64 envs, same state, noise off;
 11. actuator net: make_runner("anymal_c_rough", 4096 envs), two
     iterations (192 launches): the LSTM hidden state is non-zero after a
     collect and zero on the rows of the envs that just reset;
 12. recurrent: make_runner("go1_flat_lstm", 4096 envs), two iterations
     through RecurrentRunner.learn and a third by hand (collect and
     update timed apart; 288 launches; one launch of each LSTM kernel a
     step of every minibatch's unroll, 1440 each); and one recurrent
     `update` of the task's registered policy (LSTM 512, heads
     512-256-128) on the card against the CPU (T = 8, N = 16) in
     lockstep: at each of its 20 Adam steps the CPU's clipped gradients
     within RECURRENT_GRAD_RTOL of the card's, leaf by leaf, and then
     replaced by them, so both sides step with the same gradients; the
     losses within rtol 1e-4, the learning rates equal, the parameters
     within rtol 1e-4 / atol 1e-5;
 13. the other robots: cassie, a1 and anymal_b, one iteration each at
     4096 envs (96 launches each), so that every timed kernel shape is
     also launched from an env;
 14. export -> play: `python -m dwbc_tpu_torch.runner.export` of the go1
     and the widowGo1 checkpoints of phases 9 and 6 on the card, both
     programs (policy.pt2, hist_encoder.pt2) loaded and held against the
     live model at batch 1 and 4096 (atol 1e-5), then `play --use_jit` of
     5 envs x 50 steps from the program (200 launches each), the npz's
     keys and shapes checked; export seconds, load seconds and play's
     env-steps/s printed;
 15. two ranks on one card: two processes of this script (gloo, which
     all-reduces CUDA tensors through the host: NCCL refuses two ranks on
     one GPU) train go1 at 4096 envs split 2048 + 2048 for two iterations
     (192 launches per rank); parameters and learning rate bitwise equal
     across the ranks, metrics.jsonl and the checkpoint from rank 0 only;
     then one-epoch one-minibatch updates on each rank's half of a
     trajectory (the go1 MLP and the go1_flat_lstm recurrent policy)
     against one process's update over the whole of it on the card (rtol
     1e-3, atol 1e-5);
 16. NCCL at world size 1: `python -m torch.distributed.run --standalone
     --nproc_per_node=1` of this script with --nccl-worker, which calls
     the train CLI's main() (`--task go1 --num_envs 4096
     --max_iterations 2`) and writes the kernels' launches back (192
     each of the contact and the ABA kernel); its Perf/total_fps beside
     the single-process go1 fps of phase 9;
 17. cold path: 600 substeps of sim/engine.make_batched_step (the
     unfused step, plain torch) for widowGo1 standing under PD hold at
     1024 envs (finite, base height 0.24-0.35 m), and 2 substeps of 4 of
     those envs on the card against the CPU (atol 1e-4);
 18. repairs: solve_spd on SPD, zero-pivot and NaN matrices (NaN only in
     the NaN matrix, the rest as on the CPU), aba with a massless env
     (non-finite in that env only, no raise), the heightfield at NaN, inf
     and 1e20 coordinates (no device-side assert), one widowGo1_adaptive
     step at 1024 envs with one env's velocities NaN (that env bad and
     reset, everything else finite); and the wall time of one
     `_osc_target` call at 1024 envs with solve_spd's pivot-floored
     factorisation and with the raising Cholesky it replaced, in turns.
Every env a phase builds must have its (spheres, bodies, envs) among
KERNEL_SHAPES. Every phase that steps an env on the card reads the three
kernels' launch totals (utils/spans.total) first and requires the contact
and the ABA kernel to have launched once per physics substep each, and
the FK kernel once per substep, once per env step for the terrain's
tangent planes and, in widowGo1's family, once more per env step for the
EE pose (launches_since_reset, fk_launches).
The last two lines are the kernels' JSON record (contact_law, aba, fk,
lstm_forward and lstm_backward: launches on the main path, device and
plain ms, bound) and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Results are also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from dwbc_tpu_torch.utils.measure import (
    N_SETS, PLAIN_LAUNCHES, TIMED_LAUNCHES, card, device_kernel_rows,
    device_ms, law_bound_ms, law_bytes, random_scene)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
NUM_ENVS = 8192
VARIANT_ENVS = 1024
NUM_STEPS = 40
DECIMATION = 4
LEGGED_ENVS = 4096
LEGGED_STEPS = 24
# (ng, nb, N, geom->body map sorted); the first two are the shapes the
# driven paths give the kernel
PLAY_ENVS = 5
PLAY_STEPS = 50
KERNEL_SHAPES = ((84, 21, NUM_ENVS, True), (84, 21, VARIANT_ENVS, True),
                 (84, 21, NUM_ENVS + 77, True),
                 (13, 5, 1, True), (128, 32, 33, True),
                 (84, 21, NUM_ENVS, False),
                 (92, 13, LEGGED_ENVS, True), (76, 13, LEGGED_ENVS, True),
                 (28, 13, LEGGED_ENVS, True), (22, 13, LEGGED_ENVS, True),
                 (5, 13, LEGGED_ENVS, True),
                 # play's widths, and one rank's half of go1's 4096 envs
                 (92, 13, PLAY_ENVS, True), (84, 21, PLAY_ENVS, True),
                 (92, 13, LEGGED_ENVS // 2, True),
                 # widowGo1_flat's and widowGo1_adaptive's learning curves
                 (84, 21, LEGGED_ENVS, True), (84, 21, LEGGED_ENVS // 2, True))
# (tree, envs) of the ABA kernel's check: the benchmark's widowGo1 and go1
# cells, the slice and train phases' width, play's 5 envs (one partial
# block); the first is the kernels line's main shape
ABA_SHAPES = (("widowGo1", 5000), ("widowGo1", NUM_ENVS),
              ("go1", LEGGED_ENVS), ("widowGo1", PLAY_ENVS),
              ("go1", PLAY_ENVS))
ABA_RTOL = 1e-5
# (memories, steps, rows, units) of the LSTM kernels' check: a minibatch of
# the recurrent cell (go1_flat_lstm's LSTM 512, 1,024 of its 4,096 envs, 24
# steps), and odd sizes
LSTM_SHAPES = ((2, LEGGED_STEPS, LEGGED_ENVS // 4, 512), (2, 5, 33, 64))
LSTM_RTOL = 1e-5
# the recurrent update check's bound on each Adam step's gradients card
# vs CPU, leaf by leaf (relative norm)
RECURRENT_GRAD_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def host_us(fn, args, calls=20):
    """Host time of one eager call of fn(*args) (Python, checks, output
    allocation, the launch itself), queued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# the hand kernels' launch counters (utils/spans), and their totals at the
# last reset_launches(): the env step's three, then the LSTM unroll's two
KERNEL_COUNTERS = ("contact_kernel", "aba_kernel", "fk_kernel",
                   "lstm_kernel", "lstm_backward_kernel")
_AT_RESET = dict.fromkeys(KERNEL_COUNTERS, 0)


def reset_launches():
    """Take the hand kernels' launch totals before a main-path phase."""
    from dwbc_tpu_torch.utils import spans
    _AT_RESET.update((k, spans.total(k)) for k in KERNEL_COUNTERS)


def launch_counts():
    """(contact, ABA, FK, LSTM forward, LSTM backward) kernel launches
    since reset_launches()."""
    from dwbc_tpu_torch.utils import spans
    return tuple(spans.total(k) - _AT_RESET[k] for k in KERNEL_COUNTERS)


def fk_launches(task, steps):
    """FK kernel launches of `steps` env steps of `task`: one a physics
    substep, one an env step for the terrain's tangent planes
    (sim/fused.py sample_terrain) and, in widowGo1's family, one more an
    env step for the EE pose in the post-step (envs/widowgo1.py
    _ee_world)."""
    return steps * (DECIMATION + 1 + int(task.startswith("widowGo1")))


# FK and LSTM launches held to their expected counts on the main path, for
# the kernels line
FK_CHECKED = [0]
LSTM_CHECKED = [0]


def check_fk(what, got, want):
    """Raise unless the FK kernel launched `want` times; count them."""
    if got != want:
        raise AssertionError(f"{what} launched the FK kernel {got} times, "
                             f"expected {want}")
    FK_CHECKED[0] += want


def launches_since_reset(what, expect, fk_expect):
    """The launches of the hand kernels since reset_launches(): the
    contact and the ABA kernel one each per physics substep, so the two
    counts must agree, and equal `expect` where it is not None; the FK
    kernel `fk_expect` (fk_launches). Returns the contact count."""
    contact, aba, fk, *_ = launch_counts()
    want = contact if expect is None else expect
    if (contact, aba) != (want, want):
        raise AssertionError(f"{what} launched the contact kernel {contact} "
                             f"and the ABA kernel {aba} times, expected "
                             f"{want} each")
    check_fk(what, fk, fk_expect)
    return want


def build_phase():
    """Phase 2: compile the hand kernels with nvcc (force) and log ptxas's
    register and spill report; raises where the ABA, the FK or the LSTM
    kernels spill."""
    from dwbc_tpu_torch.ops import (aba_kernel, contact_kernel, fk_kernel,
                                    lstm_kernel)
    for k, spill_free in ((contact_kernel.KERNEL, False),
                          (aba_kernel.KERNEL, True), (fk_kernel.KERNEL, True),
                          (lstm_kernel.FORWARD, True)):
        t0 = time.time()
        report = k.build(force=True)
        log(f"build: {os.path.relpath(k.source, ROOT)} -> "
            f"{os.path.relpath(k.library, ROOT)} in "
            f"{time.time() - t0:.2f} s")
        for line in report.splitlines():
            if any(w in line for w in ("properties", "registers", "spill")):
                log(f"  ptxas: {line.strip()}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", report)]
        if spill_free and (not spills or any(spills)):
            raise AssertionError(f"{os.path.basename(k.source)}: spill "
                                 f"bytes {spills} in ptxas's report")


def rel_err(got, want):
    """Norm of the difference over the norm of `want`, in float64."""
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def aba_phase(device, shapes=ABA_SHAPES):
    """Phase 3b: the ABA kernel (ops/aba_kernel.aba) against its plain
    version (sim/aba.fused_aba) on the same card tensors at ABA_SHAPES,
    over N_SETS random states per shape; in the first, the last env's
    masses and inertias are 1e-9 of the model's, so that its base block's
    pivots fall under the solve's 1e-6 floor. Each output within ABA_RTOL
    (rel_err) over the regular envs and over that env alone, finite, and
    one launch counted per call. Then, per shape: the kernel's device time
    per launch (a CUDA graph rotating over the sets), the plain version's
    device time and both host times per call, and the byte bound of these
    inputs (measure.aba_bytes) at the HBM rate."""
    from dwbc_tpu_torch.ops.aba_kernel import aba
    from dwbc_tpu_torch.sim.aba import fused_aba
    from dwbc_tpu_torch.sim.engine import SimParams
    from dwbc_tpu_torch.sim.tree import tree_const
    from dwbc_tpu_torch.utils import spans
    from dwbc_tpu_torch.utils.measure import (
        HBM_BYTES_PER_S, aba_args, aba_bytes, aba_model, random_aba_state)

    trees, rows = {}, []
    for name, n in shapes:
        if name not in trees:
            m, i_eff = aba_model(name)
            trees[name] = m, tree_const(m, SimParams(), i_eff, device)
        m, tc = trees[name]
        tag = f"{name} nb={m.nb} N={n}"
        floor_env = n - 1
        sets = []
        for i in range(N_SETS):
            s = random_aba_state(m, n, seed=1000 * n + i)
            if i == 0:
                s["mass"][floor_env] *= 1e-9
                s["inertia"][floor_env] *= 1e-9
            sets.append((tc, *aba_args(m, s, device)[0]))
        regular = torch.arange(n, device=device) != floor_env
        err = floor_err = 0.0
        for i, args in enumerate(sets):
            want = fused_aba(*args)
            before = spans.total("aba_kernel")
            got = aba(*args)
            torch.cuda.synchronize()
            counted = spans.total("aba_kernel") - before
            if counted != 1:
                raise AssertionError(f"aba {tag}: {counted} launches counted "
                                     f"for one call")
            groups = ([("regular envs", regular),
                       ("the pivot-floor env", ~regular)] if i == 0
                      else [("all envs", torch.ones_like(regular))])
            for part, g, w in zip(("qdd", "ang_acc", "lin_acc"), got, want):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"aba {tag} set {i}: non-finite "
                                         f"{part}")
                for label, mask in groups:
                    e = rel_err(g[mask], w[mask])
                    if not e < ABA_RTOL:
                        raise AssertionError(
                            f"aba {tag} set {i} {part} over {label}: "
                            f"relative error {e:.3g} >= {ABA_RTOL}")
                    if label == "the pivot-floor env":
                        floor_err = max(floor_err, e)
                    else:
                        err = max(err, e)
        ms = device_ms(aba, sets, TIMED_LAUNCHES)
        plain_ms = device_ms(fused_aba, sets, PLAIN_LAUNCHES)
        wrapper_us = host_us(aba, sets[0])
        plain_us = host_us(fused_aba, sets[0], calls=5)
        nbytes = aba_bytes(sets[0][1:], tc.table)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(tree=name, nb=m.nb, n=n, max_rel_err=err,
                   pivot_floor_rel_err=floor_err, ms=ms, plain_ms=plain_ms,
                   host_us=wrapper_us, plain_host_us=plain_us,
                   bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                   share_of_bound=bound_ms / ms)
        log(f"kernel aba {tag}: max_rel_err={err:.3g} (pivot-floor env "
            f"{floor_err:.3g}) ms={ms:.5f} ({row['share_of_bound']:.1%} of "
            f"the bound) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({nbytes / 1e6:.2f} MB, bytes); wrapper host "
            f"{wrapper_us:.1f} us/call, plain host {plain_us:.0f} us/call")
        rows.append(row)
    return rows


def fk_phase(device, shapes=ABA_SHAPES):
    """Phase 3c: the FK kernel (ops/fk_kernel.fk) against its plain
    version (sim/fk.fused_fk) on the same card tensors at ABA_SHAPES, with
    qd and without, over N_SETS random states per shape (random_aba_state's
    q and qd). Rotations, positions and velocities finite and within
    ABA_RTOL (rel_err), one launch counted per call. Then, per shape: the
    kernel's device time per launch (a CUDA graph rotating over the sets),
    the plain version's device time and both host times per call, and the
    byte bound (measure.fk_bytes) at the HBM rate."""
    from dwbc_tpu_torch.ops.fk_kernel import fk
    from dwbc_tpu_torch.sim.engine import SimParams
    from dwbc_tpu_torch.sim.fk import fused_fk
    from dwbc_tpu_torch.sim.tree import tree_const
    from dwbc_tpu_torch.utils import spans
    from dwbc_tpu_torch.utils.measure import (
        HBM_BYTES_PER_S, aba_model, fk_bytes, random_aba_state)

    trees, rows = {}, []
    for name, n in shapes:
        if name not in trees:
            m, i_eff = aba_model(name)
            trees[name] = m, tree_const(m, SimParams(), i_eff, device)
        m, tc = trees[name]
        for with_qd in (True, False):
            tag = f"{name} nb={m.nb} N={n} {'with' if with_qd else 'no'} qd"
            sets = []
            for i in range(N_SETS):
                s = random_aba_state(m, n, seed=2000 * n + i)
                q = torch.as_tensor(s["q"], device=device)
                qd = torch.as_tensor(s["qd"], device=device)
                sets.append((tc, q, qd) if with_qd else (tc, q))
            err, differ = 0.0, 0
            for i, args in enumerate(sets):
                want = fused_fk(*args)
                before = spans.total("fk_kernel")
                got = fk(*args)
                torch.cuda.synchronize()
                counted = spans.total("fk_kernel") - before
                if counted != 1:
                    raise AssertionError(f"fk {tag}: {counted} launches "
                                         f"counted for one call")
                for part, g, w in zip(("R", "p", "v"), got, want):
                    if w is None:
                        if g is not None:
                            raise AssertionError(f"fk {tag}: v without qd")
                        continue
                    if g.shape != w.shape or not bool(
                            torch.isfinite(g).all()):
                        raise AssertionError(f"fk {tag} set {i}: {part} of "
                                             f"shape {tuple(g.shape)}, or "
                                             f"non-finite")
                    e = rel_err(g, w)
                    if not e < ABA_RTOL:
                        raise AssertionError(
                            f"fk {tag} set {i} {part}: relative error "
                            f"{e:.3g} >= {ABA_RTOL}")
                    err = max(err, e)
                    differ += int((g != w).sum())
            ms = device_ms(fk, sets, TIMED_LAUNCHES)
            plain_ms = device_ms(fused_fk, sets, PLAIN_LAUNCHES)
            wrapper_us = host_us(fk, sets[0])
            plain_us = host_us(fused_fk, sets[0], calls=5)
            nbytes = fk_bytes(m.nb, n, with_qd)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(tree=name, nb=m.nb, n=n, with_qd=with_qd,
                       max_rel_err=err, differing_entries=differ, ms=ms,
                       plain_ms=plain_ms,
                       host_us=wrapper_us, plain_host_us=plain_us,
                       bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                       share_of_bound=bound_ms / ms)
            log(f"kernel fk {tag}: max_rel_err={err:.3g} ({differ} entries "
                f"differ from the eager version's) ms={ms:.5f} "
                f"({row['share_of_bound']:.1%} of the bound) "
                f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
                f"({nbytes / 1e6:.2f} MB, bytes); wrapper host "
                f"{wrapper_us:.1f} us/call, plain host {plain_us:.0f} "
                f"us/call")
            rows.append(row)
    return rows


def lstm_inputs(m, t_len, b, h, seed, device):
    """Random inputs of ops/lstm_kernel.lstm_sequence: projections and
    carries of the scale a trained LSTM sees, orthogonal-scale recurrent
    kernels, and resets on about 5% of the rows at every step, at least
    one at step 0, in the middle and at the last step."""
    g = torch.Generator(device=device).manual_seed(seed)
    keep = (torch.rand((t_len, b), generator=g, device=device) > 0.05)
    keep[0, 0] = keep[t_len // 2, b // 2] = keep[-1, b - 1] = False
    keep = keep.float()

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)

    return (r(m, t_len, b, 4 * h), r(m, b, h, scale=0.5) * keep[0][:, None],
            r(m, b, h, scale=0.5) * keep[0][:, None],
            r(m, 4 * h, h, scale=h ** -0.5), keep)


def library_step(kind, m, b, h, device, seed):
    """One step of the library route, ATen's fused LSTM cell
    (aten._thnn_fused_lstm_cell, its backward _impl) with the done mask
    as separate ops, and one argument set for it (a step with a next one,
    both memories as M x B rows): forward the cell, then c and h times
    the next keep; backward dh = dy + dh_next keep and dc = dc_next keep,
    then the cell's backward."""
    aten = torch.ops.aten
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=device)
    rows = m * b
    k = (torch.rand((rows, 1), generator=g, device=device) > 0.05).float()
    if kind == "forward":
        def step(ig, hg, cx, k, c_next, h_next):
            hy, cy, _ = aten._thnn_fused_lstm_cell(ig, hg, cx)
            torch.mul(cy, k, out=c_next)
            torch.mul(hy, k, out=h_next)
        return step, (r(rows, 4 * h), r(rows, 4 * h), r(rows, h), k,
                      r(rows, h), r(rows, h))

    def step(dy, dh_next, k, dc_next, cx, cy, ws):
        aten._thnn_fused_lstm_cell_backward_impl(
            torch.addcmul(dy, dh_next, k), dc_next * k, cx, cy, ws, False)
    _, cy, ws = aten._thnn_fused_lstm_cell(r(rows, 4 * h), r(rows, 4 * h),
                                           r(rows, h))
    return step, (r(rows, h), r(rows, h), k, r(rows, h), r(rows, h), cy, ws)


def library_sequence(xproj, c0, h0, wh, keep, dy, dc_last):
    """lstm_sequence's forward and backward by the library route
    (library_step's ops a step, each memory's rows stacked as M x B, the
    products as in the op): (y, the final c, and the gradients of xproj,
    c0, h0 and wh), in the op's layouts."""
    aten = torch.ops.aten
    m, t_len, b, h4 = xproj.shape
    h, rows = h4 // 4, m * b
    xp = xproj.transpose(0, 1).reshape(t_len, rows, h4)
    k = keep.repeat(1, m)[..., None]
    wht = wh.transpose(1, 2)
    cx, hx = c0.reshape(rows, h), h0.reshape(rows, h)
    ys, saved = [], []
    for t in range(t_len):
        hg = torch.bmm(hx.view(m, b, h), wht).view(rows, h4)
        hy, cy, ws = aten._thnn_fused_lstm_cell(xp[t], hg, cx)
        ys.append(hy)
        saved.append((cx, hx, cy, ws))
        if t + 1 < t_len:
            cx, hx = cy * k[t + 1], hy * k[t + 1]
    dyv = dy.transpose(0, 1).reshape(t_len, rows, h)
    dc, dh_next, dgs = dc_last.reshape(rows, h), None, [None] * t_len
    for t in reversed(range(t_len)):
        dh = dyv[t]
        if dh_next is not None:
            dh, dc = torch.addcmul(dh, dh_next, k[t + 1]), dc * k[t + 1]
        cx, _, cy, ws = saved[t]
        dgs[t], dc, _ = aten._thnn_fused_lstm_cell_backward_impl(
            dh, dc, cx, cy, ws, False)
        dh_next = torch.bmm(dgs[t].view(m, b, h4), wh).view(rows, h)
    dg = torch.stack(dgs).view(t_len, m, b, h4).transpose(0, 1)
    hm = torch.stack([s[1] for s in saved]).view(t_len, m, b, h)
    dwh = torch.bmm(dg.reshape(m, t_len * b, h4).transpose(1, 2),
                    hm.transpose(0, 1).reshape(m, t_len * b, h))
    return (torch.stack(ys).view(t_len, m, b, h).transpose(0, 1),
            saved[-1][2].view(m, b, h), dg, dc.view(m, b, h),
            dh_next.view(m, b, h), dwh)


def lstm_phase(device, shapes=LSTM_SHAPES):
    """Phase 3d: the LSTM sequence op with its kernels
    (ops/lstm_kernel.lstm_sequence) against the same op with the plain
    gate steps (plain_sequence) on the same card tensors at LSTM_SHAPES,
    forward and backward with random output gradients: y, the final c and
    the gradients of the projections, the first carry and the recurrent
    kernels finite and within LSTM_RTOL (rel_err); T launches of each
    kernel counted per sequence, none for the plain one. Then, per shape,
    each kernel's device time per launch for one step (T = 2, t = 0: a
    step with a next one), a CUDA graph over N_SETS buffer sets, beside
    its plain step's and both host times, and its byte bound
    (measure.lstm_bytes) at the HBM rate; and the whole sequence's
    forward and backward, kernels against plain, on the stream's clock
    (host gaps included)."""
    from dwbc_tpu_torch.ops import lstm_kernel
    from dwbc_tpu_torch.utils import spans
    from dwbc_tpu_torch.utils.measure import HBM_BYTES_PER_S, lstm_bytes

    names = ("y", "c", "dxproj", "dc0", "dh0", "dwh")
    counters = ("lstm_kernel", "lstm_backward_kernel")
    rows = []
    for m, t_len, b, h in shapes:
        tag = f"M={m} T={t_len} B={b} H={h}"
        xs = lstm_inputs(m, t_len, b, h, seed=t_len * b + h, device=device)

        def run(op):
            """The op forward and backward from xs: (y, c and the
            gradients, launches counted, ms on the stream's clock)."""
            args = [x.clone().requires_grad_() for x in xs[:4]]
            before = [spans.total(k) for k in counters]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            y, c = op(*args, xs[4])
            g = torch.Generator(device=device).manual_seed(1)
            dy = torch.randn(y.shape, generator=g, device=device)
            dc = torch.randn(c.shape, generator=g, device=device)
            torch.autograd.backward((y, c), (dy, dc))
            end.record()
            torch.cuda.synchronize()
            counted = [spans.total(k) - n for k, n in zip(counters, before)]
            return ([y.detach(), c.detach()] + [a.grad for a in args],
                    counted, start.elapsed_time(end))

        # each twice, the second timed: the first call loads the library
        (got, counted, seq_ms), (want, plain_counted, plain_seq_ms) = [
            run(op) for op in (lstm_kernel.lstm_sequence,
                               lstm_kernel.plain_sequence) * 2][2:]
        if counted != [t_len, t_len] or plain_counted != [0, 0]:
            raise AssertionError(f"lstm {tag}: launches {counted} (kernels) "
                                 f"and {plain_counted} (plain), expected "
                                 f"{t_len} each and none")
        errs = {}
        for name, g_, w_ in zip(names, got, want):
            if not bool(torch.isfinite(g_).all()):
                raise AssertionError(f"lstm {tag}: non-finite {name}")
            errs[name] = rel_err(g_, w_)
            if not errs[name] < LSTM_RTOL:
                raise AssertionError(f"lstm {tag} {name}: relative error "
                                     f"{errs[name]:.3g} >= {LSTM_RTOL}")

        def run_library():
            """library_sequence from xs with run's output gradients:
            (its results, ms on the stream's clock)."""
            g = torch.Generator(device=device).manual_seed(1)
            dy = torch.randn((m, t_len, b, h), generator=g, device=device)
            dc = torch.randn((m, b, h), generator=g, device=device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = library_sequence(*xs, dy, dc)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)

        lib, lib_seq_ms = [run_library() for _ in range(2)][1]
        lib_errs = {name: rel_err(g_, w_)
                    for name, g_, w_ in zip(names, lib, want)}
        # one step alone, with a next one (T = 2, t = 0)
        fwd, bwd = lstm_kernel.steps(True, (2, b, h, m))
        row = dict(m=m, t=t_len, b=b, h=h, rel_err=errs,
                   sequence_ms=seq_ms, plain_sequence_ms=plain_seq_ms,
                   library_sequence_ms=lib_seq_ms, library_rel_err=lib_errs)
        for kind, step, plain in (
                ("forward", fwd, lstm_kernel.forward_step),
                ("backward", bwd, lstm_kernel.backward_step)):
            sets = []
            for i in range(N_SETS):
                x = lstm_inputs(m, 2, b, h, seed=100 + i, device=device)
                g4 = torch.randn((m, 2, b, 4 * h), device=device)
                one = torch.randn((m, 2, b, h), device=device)
                hb = torch.randn((m, b, h), device=device)
                if kind == "forward":   # xproj, hh, keep, act, c, y, cm, hm
                    sets.append((x[0], torch.randn((m, b, 4 * h),
                                                   device=device), x[4],
                                 g4.sigmoid(),
                                 *(one.clone() for _ in range(4))))
                else:   # act, c, cm, keep, dy, dh_next, dc_next, dxp, dc_prev
                    sets.append((g4.sigmoid(), one, one.clone(), x[4],
                                 one.clone(), hb, hb.clone(),
                                 torch.empty_like(g4),
                                 torch.empty_like(hb)))
            ms = device_ms(lambda *a: step(0, *a), sets, TIMED_LAUNCHES)
            plain_ms = device_ms(lambda *a: plain(0, *a), sets,
                                 PLAIN_LAUNCHES)
            wrapper_us = host_us(lambda *a: step(0, *a), sets[0])
            lib_step = library_step(kind, m, b, h, device, 0)[0]
            lib_sets = [library_step(kind, m, b, h, device, 100 + i)[1]
                        for i in range(N_SETS)]
            library_ms = device_ms(lib_step, lib_sets, TIMED_LAUNCHES)
            lib_us = host_us(lib_step, lib_sets[0])
            nbytes = lstm_bytes(m, b, h, kind == "backward")
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row[kind] = dict(ms=ms, plain_ms=plain_ms, host_us=wrapper_us,
                             library_ms=library_ms, library_host_us=lib_us,
                             bytes=nbytes, bound_ms=bound_ms,
                             bound_by="bytes", share_of_bound=bound_ms / ms)
            log(f"kernel lstm {kind} {tag}: ms={ms:.5f} "
                f"({bound_ms / ms:.1%} of the bound) plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} "
                f"({nbytes / 1e6:.2f} MB, bytes); launch host "
                f"{wrapper_us:.1f} us, library {lib_us:.1f} us")
        log(f"lstm sequence {tag}: relative errors "
            + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f"; forward + backward {seq_ms:.3f} ms with the kernels, "
            f"{plain_seq_ms:.3f} ms plain, {lib_seq_ms:.3f} ms by the "
            f"library route (stream clock, host gaps included); library "
            f"route against plain: "
            + " ".join(f"{k}={v:.3g}" for k, v in lib_errs.items()))
        rows.append(row)
    return rows


def kernel_phase(device, shapes=KERNEL_SHAPES):
    from dwbc_tpu_torch.ops.contact_kernel import contact_law
    from dwbc_tpu_torch.sim.contact import fused_terrain_law
    rows = []
    for ng, nb, n, ordered in shapes:
        tag = (f"ng={ng} nb={nb} N={n} "
               f"{'sorted' if ordered else 'unsorted'} map")
        sets = [random_scene(n, ng, nb, seed=1000 * ng + n + i,
                             device=device, sorted=ordered)
                for i in range(N_SETS)]
        err = 0.0
        for args in sets:
            out = contact_law(*args)
            ref = fused_terrain_law(*args)
            torch.cuda.synchronize()
            if not torch.equal(out[2], ref[2]):
                raise AssertionError(f"{tag}: active masks differ in "
                                     f"{int((out[2] != ref[2]).sum())} places")
            for name, o, r, rtol, atol in (
                    ("gF", out[0], ref[0], 1e-5, 5e-5),
                    ("cf_new", out[1], ref[1], 1e-5, 5e-5),
                    ("share_f", out[3], ref[3], 1e-6, 0.0)):
                torch.testing.assert_close(
                    o, r, rtol=rtol, atol=atol,
                    msg=lambda m: f"{tag} {name}: {m}")
                err = max(err, float((o - r).abs().max()))
        ms = device_ms(contact_law, sets, TIMED_LAUNCHES)
        warm_ms = device_ms(contact_law, sets[:1], TIMED_LAUNCHES)
        plain_ms = device_ms(fused_terrain_law, sets, PLAIN_LAUNCHES)
        wrapper_us = host_us(contact_law, sets[0])
        nbytes = law_bytes(ng, n)
        copies = [(torch.empty(nbytes // 8, device=device),
                   torch.empty(nbytes // 8, device=device))
                  for _ in range(N_SETS)]
        copy_ms = device_ms(lambda dst, src: dst.copy_(src), copies,
                            TIMED_LAUNCHES)
        bound_ms, bound_by = law_bound_ms(ng, n)
        row = dict(ng=ng, nb=nb, n=n, sorted=ordered, max_abs_err=err,
                   ms=ms, warm_ms=warm_ms, copy_ms=copy_ms,
                   plain_ms=plain_ms, host_us=wrapper_us,
                   bound_ms=bound_ms,
                   bound_by=bound_by,
                   bytes=nbytes, gbps=nbytes / ms / 1e6,
                   share_of_bound=bound_ms / ms)
        log(f"kernel contact_law {tag}: max_abs_err={err:.3g} ms={ms:.5f} "
            f"({row['gbps']:.1f} GB/s, {row['share_of_bound']:.1%} of the "
            f"bound) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({nbytes / 1e6:.2f} MB, {row['bound_by']}); L2-warm "
            f"{warm_ms:.5f} ms, copy of the same bytes {copy_ms:.5f} ms; "
            f"wrapper host {wrapper_us:.1f} us/call")
        rows.append(row)
    return rows


def state_to_card(state, device, from_numpy=None):
    """A CPU EnvState (or, with interop.legged_state_from_numpy, a
    LeggedState) copied to the card through interop's numpy tree."""
    import dataclasses as dc
    from dwbc_tpu_torch.interop import env_state_from_numpy

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if hasattr(x, "_asdict"):
            return {k: tree(v) for k, v in x._asdict().items()}
        if dc.is_dataclass(x):
            return {f.name: tree(getattr(x, f.name)) for f in dc.fields(x)
                    if f.name != "generator"}
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)

    return (from_numpy or env_state_from_numpy)(tree(state), device=device)


def step_check(device):
    """One env step on the card against the same step on the CPU."""
    from dwbc_tpu_torch.envs.widowgo1 import WidowGo1Env
    n = 64
    cpu = WidowGo1Env(num_envs=n, seed=1, device="cpu")
    gpu = WidowGo1Env(num_envs=n, seed=1, device=device)
    state, _ = cpu.reset(torch.Generator().manual_seed(0))
    gstate = state_to_card(state, device)
    actions = torch.as_tensor(
        0.3 * np.random.default_rng(0).normal(size=(n, 18)), dtype=torch.float32)
    s_c, o_c = cpu.step(state, actions, 3.0)
    s_g, o_g = gpu.step(gstate, actions.to(device), 3.0)
    torch.cuda.synchronize()
    live = ~(o_c.reset | o_g.reset.cpu())
    if not torch.equal(o_c.reset, o_g.reset.cpu()) or live.sum() < n // 2:
        raise AssertionError("card and CPU steps reset different envs")
    for name, a, b, atol in (("obs", o_g.obs, o_c.obs, 1e-3),
                             ("rew", o_g.rew, o_c.rew, 1e-5),
                             ("arm_rew", o_g.arm_rew, o_c.arm_rew, 1e-5),
                             ("q", s_g.robot.q, s_c.robot.q, 1e-3)):
        torch.testing.assert_close(a.cpu()[live], b[live], rtol=1e-3,
                                   atol=atol, msg=lambda m: f"{name}: {m}")
    err = float((o_g.obs.cpu()[live] - o_c.obs[live]).abs().max())
    log(f"step check: card vs CPU, {int(live.sum())}/{n} envs, "
        f"obs max_abs_err={err:.3g}")


def slice_phase(device, profile):
    from dwbc_tpu_torch.models.actor_critic import ActorCritic
    from dwbc_tpu_torch.rl.runner import Rollout, init_at_random_ep_len
    from dwbc_tpu_torch.utils import task_registry

    t0 = time.time()
    env, spec = task_registry.make_env("widowGo1", num_envs=NUM_ENVS, seed=1,
                                       device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state, obs = env.reset(gen)
    state = init_at_random_ep_len(state, env.max_episode_length, gen)
    torch.manual_seed(0)
    model = ActorCritic(num_prop=env.num_proprio, num_priv=env.num_priv,
                        num_hist=env.cfg.env.history_len).to(device)
    rollout = Rollout(env, model, spec.ppo_cfg, NUM_STEPS)
    torch.cuda.synchronize()
    log(f"slice build: widowGo1 x {NUM_ENVS} envs, terrain "
        f"{tuple(env.hf.height.shape)}, {time.time() - t0:.2f} s")

    noise = torch.Generator(device=device)
    noise.manual_seed(1)
    results = []
    total_launches = 0
    for counter, hist in ((1.0, True), (2.0, False)):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        state, obs, traj, stats, nres = rollout.collect(state, obs, counter,
                                                        noise, hist)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = launches_since_reset("collect", NUM_STEPS * DECIMATION,
                                        fk_launches("widowGo1", NUM_STEPS))
        total_launches += launches
        if tuple(traj.obs.shape) != (NUM_STEPS, NUM_ENVS, env.num_obs):
            raise AssertionError(f"traj.obs shape {tuple(traj.obs.shape)}")
        if tuple(traj.rewards.shape) != (NUM_STEPS, NUM_ENVS, 2):
            raise AssertionError(f"traj.rewards shape "
                                 f"{tuple(traj.rewards.shape)}")
        for name, t in (("obs", traj.obs), ("rewards", traj.rewards),
                        ("values", traj.values), ("q", state.robot.q),
                        ("qd", state.robot.qd), ("box q", state.box.q)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite {name}")
        rate = NUM_STEPS * NUM_ENVS / secs
        log(f"collect hist_encoding={hist}: {secs:.3f} s, {rate:.0f} "
            f"env-steps/s, kernel launches {launches}, resets {int(nres)}, "
            f"mean rewards {traj.rewards.mean((0, 1)).tolist()}")
        results.append(dict(hist_encoding=hist, seconds=secs,
                            env_steps_per_s=rate, launches=launches))

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        actions = torch.zeros((NUM_ENVS, env.num_actions), device=device)
        env.step(state, actions, 3.0)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.time()
            env.step(state, actions, 3.0)
            torch.cuda.synchronize()
            step_s = time.time() - t0
        events = p.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        cuda_rows = device_kernel_rows(events)
        dev_us = sum(e.self_device_time_total for e in cuda_rows)
        law = [e for e in cuda_rows if "contact_law" in e.key]
        law_n = sum(e.count for e in law)
        law_ms = (sum(e.self_device_time_total for e in law) / law_n / 1e3
                  if law_n else float("nan"))
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "profile_env_step.txt"), "w") as f:
            f.write(f"one env.step, {NUM_ENVS} envs: wall {step_s:.4f} s, "
                    f"device busy {dev_us / 1e6:.4f} s\n{table}\n")
        log(f"profile: one env.step wall {step_s:.4f} s, device busy "
            f"{dev_us / 1e6:.4f} s (chiprun_out/profile_env_step.txt); "
            f"contact kernel in the step {law_ms:.5f} ms per launch over "
            f"{law_n} launches")
        results.append(dict(profile_step_s=step_s, device_busy_s=dev_us / 1e6,
                            contact_law_in_step_ms=law_ms))
    return results, total_launches


def model_snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def fresh_dir(name):
    path = os.path.join(OUT_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def drop_checkpoints():
    """Remove the smoke runs' model_N files and exported programs (tens of
    MB together) once every phase has read what it needs: chiprun_out/
    keeps the metrics."""
    for name in os.listdir(OUT_DIR):
        if "_smoke" not in name or not os.path.isdir(os.path.join(OUT_DIR,
                                                                   name)):
            continue
        for dirpath, _, files in os.walk(os.path.join(OUT_DIR, name)):
            for f in files:
                if f.startswith("model_") or f.endswith((".pt", ".pt2")):
                    os.remove(os.path.join(dirpath, f))


def read_metrics(log_dir, lines):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != lines or any("Perf/total_fps" not in r for r in rows):
        raise AssertionError(f"{log_dir}/metrics.jsonl: {len(rows)} lines, "
                             f"expected {lines} with Perf/total_fps")
    for r in rows:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite logged values: {bad}")
    return rows


def profile_learn_step(runner, dagger, device):
    """torch.profiler over one learn step on the runner's newest
    trajectory: (wall seconds, device-busy seconds, table, top rows)."""
    from torch.profiler import ProfilerActivity, profile as prof
    args = (runner.ppo_state, runner.last_traj, runner.obs, runner.perm_gen,
            dagger)
    runner.rollout.learn_step(*args)          # warm
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        runner.rollout.learn_step(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = p.key_averages()
    cuda_rows = device_kernel_rows(events)
    busy = sum(e.self_device_time_total for e in cuda_rows) / 1e6
    top = [(e.key[:70], e.count, e.self_device_time_total / 1e3)
           for e in cuda_rows[:6]]
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    return wall, busy, table, top


def train_phase(device, profile):
    """Three training iterations of widowGo1 at 8192 envs through
    OnPolicyRunner, then a checkpoint round trip."""
    from dwbc_tpu_torch.utils import task_registry

    log_dir = fresh_dir("train_smoke")
    reset_launches()
    t0 = time.time()
    env, runner, spec = task_registry.make_runner(
        "widowGo1", num_envs=NUM_ENVS, seed=1, log_dir=log_dir, device=device)
    torch.cuda.synchronize()
    log(f"train build: make_runner widowGo1 x {NUM_ENVS} envs, "
        f"{time.time() - t0:.2f} s")
    floor = torch.tensor(spec.ppo_cfg.min_policy_std, device=device)
    iters = []
    for it in range(3):
        before = model_snapshot(runner.model)
        runner.learn(1, log_every=1)
        after = model_snapshot(runner.model)
        moved = [k for k in before if not torch.equal(before[k], after[k])]
        for k, v in after.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"iteration {it}: non-finite {k}")
        if it == 0:
            outside = [k for k in moved if "history_encoder" not in k]
            if outside or not moved:
                raise AssertionError(
                    f"the DAgger iteration moved {outside or 'nothing'}")
        else:
            if any("history_encoder" in k for k in moved) or len(moved) < 30:
                raise AssertionError(f"the PPO iteration moved {moved}")
            if not bool((runner.model.std >= floor).all()):
                raise AssertionError("std below min_policy_std")
        iters.append(dict(
            it=it, dagger=it == 0, collect_s=runner.last_collection_time,
            learn_s=runner.last_learn_time,
            fps=NUM_STEPS * NUM_ENVS / (runner.last_collection_time
                                        + runner.last_learn_time)))
    launches = launches_since_reset("training", 3 * NUM_STEPS * DECIMATION,
                                    fk_launches("widowGo1", 3 * NUM_STEPS))
    if runner.ppo_state.counter != 3 or runner.it != 3:
        raise AssertionError(f"counter {runner.ppo_state.counter}, "
                             f"it {runner.it}")
    rows = read_metrics(log_dir, 3)
    for i, r in zip(iters, rows):
        i["logged_fps"] = r["Perf/total_fps"]
        log(f"train it {i['it']} ({'DAgger' if i['dagger'] else 'PPO'}): "
            f"collect {i['collect_s']:.3f} s, learn {i['learn_s']:.4f} s, "
            f"Perf/total_fps {r['Perf/total_fps']}")

    path = os.path.join(log_dir, "model_roundtrip")
    runner.save(path)
    _, other, _ = task_registry.make_runner("widowGo1", num_envs=64, seed=2,
                                            device=device)
    other.load(path)
    for (k, a), b in zip(runner.model.state_dict().items(),
                         other.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint round trip changed {k}")
    if (other.ppo_state.counter, other.it) != (3, 3):
        raise AssertionError("checkpoint round trip lost the counters")
    log(f"checkpoint: saved, loaded into a second runner, parameters and "
        f"counter equal ({os.path.getsize(path) / 1e6:.2f} MB)")

    profiles = []
    if profile:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "profile_learn_step.txt"), "w") as f:
            for dagger in (True, False):
                name = "DAgger" if dagger else "PPO"
                wall, busy, table, top = profile_learn_step(runner, dagger,
                                                            device)
                f.write(f"one {name} learn step, {NUM_ENVS} envs x "
                        f"{NUM_STEPS} steps: wall {wall:.4f} s, device busy "
                        f"{busy:.4f} s\n{table}\n\n")
                log(f"profile: {name} learn step wall {wall:.4f} s, device "
                    f"busy {busy:.4f} s ({busy / wall:.1%}); top device "
                    f"operations (name, calls, ms): {top}")
                profiles.append(dict(step=name, wall_s=wall,
                                     device_busy_s=busy, top=top))
    return dict(iterations=iters, profiles=profiles), launches


def update_inputs():
    """Phase 7's CPU model, trajectory (T = 8, N = 64), last values and
    two permutations, made from seed 3."""
    from dwbc_tpu_torch.models.actor_critic import ActorCritic
    from dwbc_tpu_torch.rl import ppo

    T, N = 8, 64
    cfg = ppo.PPOConfig()
    torch.manual_seed(3)
    cpu_model = ActorCritic()
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    obs = f32(rng.normal(size=(T, N, 860)))
    with torch.no_grad():
        mean = cpu_model.act_mean(obs.reshape(T * N, -1), False).reshape(
            T, N, 18)
        std = cpu_model.std.detach()
        actions = mean + 0.3 * std * f32(rng.normal(size=(T, N, 18)))
        logp = ppo.logp_heads(cfg, actions, mean, std)
    dones = torch.as_tensor(rng.random((T, N)) < 0.1)
    zeros6 = torch.zeros((T, N, 6))
    traj = ppo.Transition(
        obs=obs, actions=actions, rewards=f32(rng.normal(size=(T, N, 2))),
        dones=dones, time_outs=dones & torch.as_tensor(rng.random((T, N)) < 0.5),
        values=f32(rng.normal(size=(T, N, 2))), log_probs=logp,
        mu=mean + 0.1 * f32(rng.normal(size=(T, N, 18))),
        sigma=std.expand(T, N, 18).clone(), target_arm_torques=zeros6,
        current_arm_dof_pos=zeros6, current_arm_dof_vel=zeros6)
    last = f32(rng.normal(size=(N, 2)))
    perms = [torch.as_tensor(rng.permutation(T * N)) for _ in range(2)]
    return cfg, cpu_model, traj, last, perms


def updated_params(cfg, cpu_model, traj, last, perms, dev, dagger=True):
    """The parameters after one `update` (and `update_dagger` with
    `dagger`) on `dev` from a copy of `cpu_model`, on the CPU."""
    from dwbc_tpu_torch.rl import ppo

    model = copy.deepcopy(cpu_model).to(dev)
    state = ppo.PPOState(cfg, model)
    tr = ppo.Transition(*(x.to(dev) for x in traj))
    ret, adv = ppo.compute_gae(cfg, tr, last.to(dev))
    ppo.update(cfg, state, tr, ret, adv, perm=perms[0].to(dev))
    if dagger:
        ppo.update_dagger(cfg, state, tr, perm=perms[1].to(dev))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def compare_params(tag, got, want, start=None):
    """Every parameter moved from `start` (if given) and `got` within
    phase 7's tolerances of `want`; returns the largest absolute error."""
    err = 0.0
    for k, w in want.items():
        if start is not None and torch.equal(w, start[k]):
            raise AssertionError(f"{tag}: {k} did not move")
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{tag} {k}: {m}")
        err = max(err, float((got[k] - w).abs().max()))
    return err


def update_check(device):
    """One update and one update_dagger on the card against the CPU from
    the same state, trajectory (T = 8, N = 64) and permutation."""
    cfg, cpu_model, traj, last, perms = update_inputs()
    cpu = updated_params(cfg, cpu_model, traj, last, perms, "cpu")
    card_ = updated_params(cfg, cpu_model, traj, last, perms, device)
    err = compare_params("update check", card_, cpu, cpu_model.state_dict())
    log(f"update check: update + update_dagger, card vs CPU, T=8 N=64, "
        f"parameters max_abs_err={err:.3g}")
    return err


def bf16_update_check(device):
    """Phase 7's update with the bf16 observation store on (what
    DWBC_BF16_OBS=1 sets at import), card against CPU, within phase 7's
    tolerances; the same update with the store off must differ."""
    from dwbc_tpu_torch.rl import ppo

    cfg, cpu_model, traj, last, perms = update_inputs()
    saved = ppo._BF16_OBS
    try:
        ppo._BF16_OBS = False
        f32 = updated_params(cfg, cpu_model, traj, last, perms, "cpu",
                             dagger=False)
        ppo._BF16_OBS = True
        cpu = updated_params(cfg, cpu_model, traj, last, perms, "cpu",
                             dagger=False)
        card_ = updated_params(cfg, cpu_model, traj, last, perms, device,
                               dagger=False)
    finally:
        ppo._BF16_OBS = saved
    # `update` leaves the history encoder as it is: no "moved" check
    err = compare_params("bf16 update check", card_, cpu)
    store_diff = max(float((cpu[k] - f32[k]).abs().max()) for k in cpu)
    if not store_diff > 1e-6:
        raise AssertionError(f"bf16 update check: the store changed the "
                             f"parameters by only {store_diff:.3g}")
    log(f"bf16 update check: update with the bf16 observation store, card "
        f"vs CPU, T=8 N=64, parameters max_abs_err={err:.3g}; the store "
        f"moves them by up to {store_diff:.3g} from the float32 update")
    return err, store_diff


def variant_train(device, n):
    """Two training iterations of widowGo1_adaptive (adaptive arm gains +
    OSC torque supervision) at n envs: (results, kernel launches)."""
    from dwbc_tpu_torch.utils import task_registry

    log_dir = fresh_dir(f"variant_smoke_{n}")
    reset_launches()
    gc.collect()    # the earlier phases' runners, before the peak is read
    torch.cuda.reset_peak_memory_stats()
    env, runner, spec = task_registry.make_runner(
        "widowGo1_adaptive", num_envs=n, seed=1, log_dir=log_dir,
        device=device)
    runner.learn(2, log_every=1)
    launches = launches_since_reset(
        "the variant", 2 * NUM_STEPS * DECIMATION,
        fk_launches("widowGo1_adaptive", 2 * NUM_STEPS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tgt = runner.last_traj.target_arm_torques
    if tuple(tgt.shape) != (NUM_STEPS, n, 6):
        raise AssertionError(f"target_arm_torques shape {tuple(tgt.shape)}")
    if not bool(torch.isfinite(tgt).all()) or not bool(tgt.any()):
        raise AssertionError("OSC targets non-finite or all zero")
    rows = read_metrics(log_dir, 2)
    ts_loss = rows[1]["Loss/arm_torques_loss"]
    if not ts_loss > 0:
        raise AssertionError(f"Loss/arm_torques_loss = {ts_loss}")
    for p in runner.model.parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("non-finite parameter in the variant")
    for it, r in enumerate(rows):
        log(f"variant widowGo1_adaptive x {n} envs, it {it} "
            f"({'DAgger' if it == 0 else 'PPO'}): collect "
            f"{r['Perf/collection time']:.3f} s, learn "
            f"{r['Perf/learning_time']:.4f} s, Perf/total_fps "
            f"{r['Perf/total_fps']}")
    log(f"variant widowGo1_adaptive x {n} envs: Loss/arm_torques_loss "
        f"{ts_loss:.4g}, |target| max {float(tgt.abs().max()):.3g}, "
        f"launches {launches}, peak device memory {peak_gb:.2f} GB")
    return dict(num_envs=n, collect_s=[r["Perf/collection time"] for r in rows],
                learn_s=[r["Perf/learning_time"] for r in rows],
                fps=[r["Perf/total_fps"] for r in rows],
                arm_torques_loss=ts_loss, peak_device_gb=peak_gb), launches


def osc_check(device, profile):
    """The OSC expert on the card against the CPU, 64 envs, one state.
    With `profile`, also its wall time per call on the card at the
    variant's widths: (max abs error, {envs: ms per call})."""
    from dwbc_tpu_torch.utils import task_registry

    # The arm is bent away from its straight default pose: there the
    # task-space matrix is near singular and two float32 solves agree to
    # 1e-3 at best.
    m = 64
    cpu_env, _ = task_registry.make_env("widowGo1_adaptive", m, device="cpu")
    gpu_env, _ = task_registry.make_env("widowGo1_adaptive", m, device=device)
    state, _ = cpu_env.reset(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    state.robot.q[:, 19:25] = f32(np.array([0.3, -0.6, 0.8, 0.4, 0.7, 0.3])
                                  + 0.1 * rng.normal(size=(m, 6)))
    state.robot.qd[:] = f32(0.5 * rng.normal(size=tuple(state.robot.qd.shape)))
    state.curr_ee_goal_cart[:] = f32(np.array([0.5, 0.0, 0.4])
                                     + 0.2 * rng.normal(size=(m, 3)))
    want = cpu_env._osc_target(state)
    got = gpu_env._osc_target(state_to_card(state, device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                               msg=lambda s: f"_osc_target: {s}")
    osc_err = float((got - want).abs().max())
    log(f"osc check: card vs CPU, {m} envs, max_abs_err={osc_err:.3g} "
        f"(|target| max {float(want.abs().max()):.3g})")
    call_ms = {}
    for n in (VARIANT_ENVS, NUM_ENVS) if profile else ():
        env, _ = task_registry.make_env("widowGo1_adaptive", n, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        state, _ = env.reset(gen)
        env._osc_target(state)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            env._osc_target(state)
        torch.cuda.synchronize()
        call_ms[n] = (time.perf_counter() - t0) * 100.0
        log(f"profile: _osc_target x {n} envs, {call_ms[n]:.2f} ms of wall "
            f"time per call (one call per policy step)")
    return osc_err, call_ms


def check_kernel_shape(env, num_envs=None):
    """Every shape an env gives the kernel has a kernel-vs-plain row (an
    env of `env`'s robot with `num_envs` envs, if given)."""
    shape = (len(env.model.geom_body), env.model.nb, num_envs or env.num_envs)
    if shape not in {s[:3] for s in KERNEL_SHAPES}:
        raise AssertionError(f"no kernel check at (ng, nb, N) = {shape}")
    return shape


def legged_train(device, task, iterations):
    """`iterations` training iterations of a single-head task at 4096
    envs x 24 steps through make_runner / OnPolicyRunner.learn, one call
    of learn each: (env, runner, log_dir, per-iteration rows, launches)."""
    from dwbc_tpu_torch.utils import task_registry

    log_dir = fresh_dir(f"{task}_smoke")
    reset_launches()
    t0 = time.time()
    env, runner, spec = task_registry.make_runner(
        task, num_envs=LEGGED_ENVS, seed=1, log_dir=log_dir, device=device)
    torch.cuda.synchronize()
    shape = check_kernel_shape(env)
    log(f"{task} build: make_runner x {LEGGED_ENVS} envs, kernel shape "
        f"{shape}, obs {env.num_obs}, terrain "
        f"{tuple(env.hf.height.shape)}, {time.time() - t0:.2f} s")
    if spec.num_steps_per_env != LEGGED_STEPS:
        raise AssertionError(f"{task}: {spec.num_steps_per_env} steps")
    start = model_snapshot(runner.model)
    step_rew = []
    for it in range(iterations):
        runner.learn(1, log_every=1)
        traj = runner.last_traj
        step_rew.append(float(traj.rewards.mean()))
        if tuple(traj.obs.shape) != (LEGGED_STEPS, LEGGED_ENVS, env.num_obs):
            raise AssertionError(f"traj.obs shape {tuple(traj.obs.shape)}")
        if tuple(traj.rewards.shape) != (LEGGED_STEPS, LEGGED_ENVS, 1):
            raise AssertionError(f"traj.rewards shape "
                                 f"{tuple(traj.rewards.shape)}")
        state = runner.env_state
        for name, t in (("obs", traj.obs), ("rewards", traj.rewards),
                        ("values", traj.values), ("q", state.robot.q),
                        ("qd", state.robot.qd),
                        ("carry", state.contact_carry["terr"]),
                        ("hidden", state.actuator_hidden)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{task} iteration {it}: non-finite "
                                     f"{name}")
    launches = launches_since_reset(
        task, iterations * LEGGED_STEPS * DECIMATION,
        fk_launches(task, iterations * LEGGED_STEPS))
    for k, v in model_snapshot(runner.model).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{task}: non-finite {k}")
        if torch.equal(v, start[k]):
            raise AssertionError(f"{task}: {k} did not move")
    if (runner.ppo_state.counter, runner.it) != (iterations, iterations):
        raise AssertionError(f"{task}: counter {runner.ppo_state.counter}, "
                             f"it {runner.it}")
    rows = read_metrics(log_dir, iterations)
    for r, rew in zip(rows, step_rew):
        if not 0.0 <= r["Episode/terrain_level"] <= 9.0:
            raise AssertionError(f"Episode/terrain_level = "
                                 f"{r['Episode/terrain_level']}")
        log(f"{task} x {LEGGED_ENVS} envs it {r['it']}: collect "
            f"{r['Perf/collection time']:.3f} s, learn "
            f"{r['Perf/learning_time']:.4f} s, Perf/total_fps "
            f"{r['Perf/total_fps']}, terrain level "
            f"{r['Episode/terrain_level']:.2f}, mean step reward "
            f"{rew:.4f}")
    result = dict(task=task, num_envs=LEGGED_ENVS, kernel_shape=shape,
                  collect_s=[r["Perf/collection time"] for r in rows],
                  learn_s=[r["Perf/learning_time"] for r in rows],
                  fps=[r["Perf/total_fps"] for r in rows], launches=launches)
    return env, runner, log_dir, result


def legged_phase(device, profile):
    """go1 on the grid terrain at full width, then what only this phase
    checks: the checkpoint, a step without host synchronisation, and with
    `profile` the table of one env step."""
    import warnings
    from dwbc_tpu_torch.utils import task_registry

    env, runner, log_dir, result = legged_train(device, "go1", 3)
    if env.num_obs != 235 or env.height_points.shape[0] != 187:
        raise AssertionError("go1: not the 187-point height scan")
    path = os.path.join(log_dir, "model_roundtrip")
    runner.save(path)
    _, other, _ = task_registry.make_runner("go1", num_envs=64, seed=2,
                                            device=device)
    other.load(path)
    for (k, a), b in zip(runner.model.state_dict().items(),
                         other.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"go1 checkpoint round trip changed {k}")
    if (other.ppo_state.counter, other.it) != (3, 3):
        raise AssertionError("go1 checkpoint round trip lost the counters")
    log(f"go1 checkpoint: saved, loaded into a second runner, parameters "
        f"and counter equal ({os.path.getsize(path) / 1e6:.2f} MB)")

    # a step must queue its work and return: any operation that waits for
    # the card (an .item(), a tensor built from Python numbers) warns here
    actions = torch.zeros((LEGGED_ENVS, env.num_actions), device=device)
    state = runner.env_state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        env.step(state, actions)
        queue_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    if syncs:
        raise AssertionError(f"go1 env.step waited for the card "
                             f"{len(syncs)} times: {syncs[:3]}")
    log(f"go1 env.step x {LEGGED_ENVS} envs: no host synchronisation; "
        f"queued in {queue_s:.4f} s, done in {step_s:.4f} s")
    result.update(step_queue_s=queue_s, step_done_s=step_s)

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.time()
            env.step(state, actions)
            torch.cuda.synchronize()
            wall = time.time() - t0
        events = p.key_averages()
        cuda_rows = device_kernel_rows(events)
        busy = sum(e.self_device_time_total for e in cuda_rows) / 1e6
        top = [(e.key[:60], e.count, e.self_device_time_total / 1e3)
               for e in cuda_rows[:6]]
        n_kernels = sum(e.count for e in cuda_rows)
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "profile_go1_step.txt"), "w") as f:
            f.write(f"one go1 env.step, {LEGGED_ENVS} envs: wall {wall:.4f} "
                    f"s, device busy {busy:.4f} s, {n_kernels} device "
                    f"kernels\n{table}\n")
        log(f"profile: one go1 env.step wall {wall:.4f} s, device busy "
            f"{busy:.4f} s ({busy / wall:.1%}), {n_kernels} device kernels "
            f"(chiprun_out/profile_go1_step.txt); top device operations "
            f"(name, calls, ms): {top}")
        result.update(profile_step_s=wall, device_busy_s=busy,
                      device_kernels=n_kernels)
    return result, result["launches"]


def legged_step_check(device):
    """One go1 step (grid terrain, heights) on the card against the CPU,
    from the same state, observation noise off: no draw reaches what is
    compared on the envs that do not reset."""
    import dataclasses as dc
    from dwbc_tpu_torch.envs import legged_config as lc
    from dwbc_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from dwbc_tpu_torch.interop import legged_state_from_numpy

    n = 64
    cfg = lc.go1_rough()
    cfg = dc.replace(cfg, noise=dc.replace(cfg.noise, add_noise=False))
    cpu = LeggedRobotEnv(cfg, num_envs=n, seed=1, device="cpu")
    gpu = LeggedRobotEnv(cfg, num_envs=n, seed=1, device=device)
    state, _ = cpu.reset(torch.Generator().manual_seed(0))
    # settle onto the terrain, so that the compared step is in contact
    zeros = torch.zeros((n, 12))
    for _ in range(12):
        state, _ = cpu.step(state, zeros)
    gstate = state_to_card(state, device, legged_state_from_numpy)
    actions = torch.as_tensor(
        0.3 * np.random.default_rng(0).normal(size=(n, 12)),
        dtype=torch.float32)
    s_c, o_c = cpu.step(state, actions)
    s_g, o_g = gpu.step(gstate, actions.to(device))
    torch.cuda.synchronize()
    live = ~(o_c.reset | o_g.reset.cpu())
    if not torch.equal(o_c.reset, o_g.reset.cpu()) or live.sum() < n // 2:
        raise AssertionError("go1: card and CPU steps reset different envs")
    in_contact = float((s_c.contact_carry["terr"].abs().sum(-1) > 0)
                       .float().mean())
    if in_contact < 0.01:
        raise AssertionError("go1 step check: no contact in the scene")
    for name, a, b, atol in (("obs", o_g.obs, o_c.obs, 1e-3),
                             ("rew", o_g.rew, o_c.rew, 1e-5),
                             ("q", s_g.robot.q, s_c.robot.q, 1e-3)):
        torch.testing.assert_close(a.cpu()[live], b[live], rtol=1e-3,
                                   atol=atol, msg=lambda m: f"go1 {name}: {m}")
    err = float((o_g.obs.cpu()[live] - o_c.obs[live]).abs().max())
    log(f"go1 step check: card vs CPU, {int(live.sum())}/{n} envs, "
        f"{in_contact:.1%} of spheres in contact, obs max_abs_err={err:.3g}")
    return err


def actuator_phase(device):
    """anymal_c_rough (the LSTM actuator net in the substep loop), two
    iterations at 4096 envs."""
    env, runner, _, result = legged_train(device, "anymal_c_rough", 2)
    state = runner.env_state
    n, nj = LEGGED_ENVS, env.model.nj
    if tuple(state.actuator_hidden.shape) != (2, 2, n * nj, 8):
        raise AssertionError(f"hidden shape "
                             f"{tuple(state.actuator_hidden.shape)}")
    per_env = state.actuator_hidden.reshape(2, 2, n, nj, 8).abs().amax(
        (0, 1, 3, 4))
    just_reset = state.reset_buf
    n_reset = int(just_reset.sum())
    if n_reset == 0:
        raise AssertionError("no env reset in the last step: nothing to "
                             "check the hidden reset on")
    if bool(per_env[just_reset].any()):
        raise AssertionError("hidden state not zero on envs that just reset")
    if not bool((per_env[~just_reset] > 0).all()):
        raise AssertionError("hidden state zero on an env that did not reset")
    log(f"anymal_c_rough: hidden state zero on the {n_reset} envs that just "
        f"reset, non-zero on the other {n - n_reset} (|h| max "
        f"{float(per_env.max()):.3g})")
    result["hidden_reset_rows"] = n_reset
    return result, result["launches"]


def recurrent_phase(device):
    """go1_flat_lstm through RecurrentRunner at 4096 envs: two iterations
    of learn, a third by hand to time collect and update apart."""
    from dwbc_tpu_torch.rl.recurrent import RecurrentRunner
    from dwbc_tpu_torch.utils import task_registry

    log_dir = fresh_dir("go1_flat_lstm_smoke")
    reset_launches()
    env, runner, spec = task_registry.make_runner(
        "go1_flat_lstm", num_envs=LEGGED_ENVS, seed=1, log_dir=log_dir,
        device=device)
    if not isinstance(runner, RecurrentRunner):
        raise AssertionError(f"runner is {type(runner).__name__}")
    shape = check_kernel_shape(env)
    start = model_snapshot(runner.model)
    iteration_s, step_rew = [], []
    for it in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        step_rew += runner.learn(1, log=None, log_every=1)
        torch.cuda.synchronize()
        iteration_s.append(time.time() - t0)
    h0 = runner.carry
    t0 = time.time()
    (runner.env_state, runner.obs, runner.carry, runner.last_dones, traj,
     last_values, ep_stats, nres) = runner.alg.collect(
        runner.env_state, runner.obs, runner.carry, runner.last_dones,
        runner.noise_gen)
    torch.cuda.synchronize()
    collect_s = time.time() - t0
    t0 = time.time()
    metrics = runner.alg.update(runner.ppo_state, traj, h0, last_values,
                                runner.perm_gen)
    torch.cuda.synchronize()
    update_s = time.time() - t0
    launches = launches_since_reset(
        "go1_flat_lstm", 3 * LEGGED_STEPS * DECIMATION,
        fk_launches("go1_flat_lstm", 3 * LEGGED_STEPS))
    # each update: one launch of each LSTM kernel a step of every
    # minibatch's unroll
    cfg = runner.alg.cfg
    lstm_want = 3 * cfg.num_learning_epochs * cfg.num_mini_batches \
        * LEGGED_STEPS
    lstm = list(launch_counts()[3:])
    if lstm != [lstm_want, lstm_want]:
        raise AssertionError(f"go1_flat_lstm launched the LSTM kernels "
                             f"{lstm} times, expected {lstm_want} each")
    LSTM_CHECKED[0] += lstm_want
    if tuple(traj.obs.shape) != (LEGGED_STEPS, LEGGED_ENVS, 48):
        raise AssertionError(f"traj.obs shape {tuple(traj.obs.shape)}")
    for name, t in (("obs", traj.obs), ("rewards", traj.rewards),
                    ("values", traj.values), ("q", runner.env_state.robot.q),
                    ("value_loss", metrics["value_loss"]),
                    ("surrogate_loss", metrics["surrogate_loss"])):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"go1_flat_lstm: non-finite {name}")
    for k, v in model_snapshot(runner.model).items():
        if not bool(torch.isfinite(v).all()) or torch.equal(v, start[k]):
            raise AssertionError(f"go1_flat_lstm: {k} non-finite or unmoved")
    if runner.ppo_state.counter != 3:
        raise AssertionError(f"counter {runner.ppo_state.counter}")
    runner.close()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = {"it", "Train/mean_step_reward", "Train/mean_reward",
            "Train/mean_episode_length", "Train/dones", "Loss/value_loss",
            "Loss/surrogate_loss"}
    if len(rows) != 2 or any(set(r) != keys for r in rows):
        raise AssertionError(f"go1_flat_lstm metrics.jsonl: {rows}")
    fps = LEGGED_STEPS * LEGGED_ENVS / (collect_s + update_s)
    log(f"go1_flat_lstm x {LEGGED_ENVS} envs (kernel shape {shape}, "
        f"{lstm_want} launches of each LSTM kernel): "
        f"RecurrentRunner.learn iterations {iteration_s[0]:.3f} s, "
        f"{iteration_s[1]:.3f} s; by hand: collect {collect_s:.3f} s, "
        f"update {update_s:.3f} s, {fps:.0f} env-steps/s; step rewards "
        f"{step_rew}; learning rate {runner.ppo_state.learning_rate:.3g}")
    return dict(task="go1_flat_lstm", num_envs=LEGGED_ENVS,
                kernel_shape=shape, iteration_s=iteration_s,
                collect_s=collect_s, update_s=update_s, fps=fps,
                launches=launches), launches


def recurrent_update_check(device):
    """One recurrent update of go1_flat_lstm's policy (its registered
    widths) on the card against the CPU from the same weights, trajectory
    (T = 8, N = 16), initial carry and permutation, in lockstep: at each of
    its Adam steps the CPU's clipped gradients are held to the card's
    (RECURRENT_GRAD_RTOL, leaf by leaf) and then replaced by them, so both
    sides step with the same gradients; then the losses, the learning
    rates and every parameter card vs CPU. Adam divides each gradient by
    its own running scale, so where both sides stepped with their own
    gradients, rounding of other summation orders in an element whose
    gradient nearly cancels moved it by a share of the learning rate, and
    an elementwise comparison of the parameters after 20 steps read that
    rounding and no fault."""
    from dwbc_tpu_torch.models.actor_critic_recurrent import (
        ActorCriticRecurrent)
    from dwbc_tpu_torch.rl import ppo
    from dwbc_tpu_torch.rl.recurrent import RecurrentPPO, RecurrentTransition
    from dwbc_tpu_torch.utils.task_registry import TASKS

    T, N = 8, 16
    spec = TASKS["go1_flat_lstm"]
    cfg, policy = spec.ppo_cfg, spec.recurrent_policy
    torch.manual_seed(4)
    cpu_model = ActorCriticRecurrent(num_obs=48, num_actions=12,
                                     **dataclasses.asdict(policy))
    rng = np.random.default_rng(4)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    h = lambda: f32(0.5 * rng.normal(size=(N, policy.rnn_hidden_size)))
    h0 = ((h(), h()), (h(), h()))
    obs = f32(rng.normal(size=(T, N, 48)))
    dones = torch.as_tensor(rng.random((T, N)) < 0.15)
    dones_prev = torch.cat([torch.zeros((1, N), dtype=torch.bool),
                            dones[:-1]])
    with torch.no_grad():
        _, (mean, _) = cpu_model.unroll(h0, obs, dones_prev)
        std = cpu_model.std.detach()
        actions = mean + 0.3 * std * f32(rng.normal(size=(T, N, 12)))
        logp = ppo.logp_heads(cfg, actions, mean, std)
    traj = RecurrentTransition(
        obs=obs, actions=actions, rewards=f32(rng.normal(size=(T, N, 1))),
        dones=dones, dones_prev=dones_prev,
        time_outs=dones & torch.as_tensor(rng.random((T, N)) < 0.5),
        values=f32(rng.normal(size=(T, N, 1))), log_probs=logp,
        mu=mean + 0.1 * f32(rng.normal(size=(T, N, 12))),
        sigma=std.expand(T, N, 12).clone())
    last = f32(rng.normal(size=(N, 1)))
    perm = torch.as_tensor(rng.permutation(N))

    names = {}

    def update(dev, hook):
        """The update on `dev` from a copy of cpu_model, hook(model)
        called before each Adam step; (parameters, rate, losses) on the
        CPU."""
        model = copy.deepcopy(cpu_model).to(dev)
        names.update({id(p): k for k, p in model.named_parameters()})
        state = ppo.PPOState(cfg, model)
        state.opt.register_step_pre_hook(lambda *_: hook(state.params))
        alg = RecurrentPPO(None, model, cfg, num_steps=T)
        metrics = alg.update(
            state, RecurrentTransition(*(x.to(dev) for x in traj)),
            tuple(tuple(x.to(dev) for x in c) for c in h0), last.to(dev),
            perm=perm.to(dev))
        return ({k: v.cpu() for k, v in model.state_dict().items()},
                state.learning_rate, {k: v.cpu() for k, v in metrics.items()})

    card_grads, grad_errs = [], []
    card, card_rate, card_losses = update(device, lambda params: (
        card_grads.append([p.grad.detach().to("cpu", copy=True)
                           for p in params])))

    def lockstep(params):
        want = card_grads[len(grad_errs)]
        grad_errs.append({names[id(p)]: rel_err(p.grad, w)
                          for p, w in zip(params, want)})
        for p, w in zip(params, want):
            p.grad.copy_(w)

    cpu, cpu_rate, cpu_losses = update(torch.device("cpu"), lockstep)
    steps = cfg.num_learning_epochs * cfg.num_mini_batches
    if len(card_grads) != steps or len(grad_errs) != steps:
        raise AssertionError(f"recurrent update check: {len(card_grads)} "
                             f"and {len(grad_errs)} Adam steps, expected "
                             f"{steps}")
    grad_err, step, leaf = max((e, i, k) for i, errs in enumerate(grad_errs)
                               for k, e in errs.items())
    if not grad_err < RECURRENT_GRAD_RTOL:
        raise AssertionError(f"recurrent update check: step {step} {leaf} "
                             f"gradient relative error {grad_err:.3g} >= "
                             f"{RECURRENT_GRAD_RTOL}")
    if cpu_rate != card_rate:
        raise AssertionError(f"learning rates differ: CPU {cpu_rate}, card "
                             f"{card_rate}")
    for k, want in cpu_losses.items():
        torch.testing.assert_close(card_losses[k], want, rtol=1e-4, atol=0,
                                   msg=lambda m: f"{k}: {m}")
    start = cpu_model.state_dict()
    err = 0.0
    for k, want in cpu.items():
        if torch.equal(want, start[k]):
            raise AssertionError(f"recurrent update check: {k} did not move")
        torch.testing.assert_close(card[k], want, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{k}: {m}")
        err = max(err, float((card[k] - want).abs().max()))
    log(f"recurrent update check: card vs CPU in lockstep, T={T} N={N}, "
        f"LSTM {policy.rnn_hidden_size}, heads {policy.actor_hidden_dims}, "
        f"{steps} Adam steps: gradients' largest relative error "
        f"{grad_err:.3g} (step {step}, {leaf}), parameters "
        f"max_abs_err={err:.3g}, learning rate {card_rate:.3g}")
    return dict(max_abs_err=err, grad_rel_err=grad_err)


def deploy_phase(device, task, ckpt):
    """Export `task`'s checkpoint on the card, hold both programs against
    the live model, and play the policy program: (results, launches)."""
    from dwbc_tpu_torch.runner import export, play
    from dwbc_tpu_torch.utils import task_registry

    out_dir = fresh_dir(f"export_smoke_{task}")
    t0 = time.time()
    export.main(["--task", task, "--checkpoint", ckpt, "--out_dir", out_dir])
    torch.cuda.synchronize()
    export_s = time.time() - t0
    env, runner, _ = task_registry.make_runner(task, num_envs=1, device=device)
    runner.load(ckpt, load_optimizer=False)
    t0 = time.time()
    programs = {name: export.load_artifact(out_dir, name, device)
                for name in export.PROGRAMS}
    load_s = time.time() - t0
    rng = np.random.default_rng(7)
    err = 0.0
    for batch in (1, LEGGED_ENVS):
        obs = torch.as_tensor(rng.normal(size=(batch, env.num_obs)),
                              dtype=torch.float32, device=device)
        with torch.no_grad():
            for name, live in (("policy", runner.model.act_mean(obs, True)),
                               ("hist_encoder",
                                runner.model.hist_latent(obs))):
                got = programs[name](obs)
                torch.testing.assert_close(
                    got, live, rtol=0, atol=1e-5,
                    msg=lambda m: f"{task} {name} at batch {batch}: {m}")
                err = max(err, float((got - live).abs().max()))

    check_kernel_shape(env, PLAY_ENVS)
    npz = os.path.join(out_dir, "play_traj.npz")
    reset_launches()
    summary = play.play(task, checkpoint=ckpt, num_envs=PLAY_ENVS,
                        steps=PLAY_STEPS, use_jit=out_dir, out=npz,
                        device=device, plot=False)
    widow = task.startswith("widowGo1")
    # play reads the EE pose once more a step in widowGo1's family
    launches = launches_since_reset(
        f"{task} play", PLAY_STEPS * DECIMATION,
        fk_launches(task, PLAY_STEPS) + widow * PLAY_STEPS)
    data = np.load(npz)
    want = {"q": (PLAY_STEPS, PLAY_ENVS, env.model.nq),
            "foot_forces": (PLAY_STEPS, PLAY_ENVS, 4, 3),
            "rew": (PLAY_STEPS, PLAY_ENVS), "dt": (),
            "ee_goal_cart": (PLAY_STEPS, PLAY_ENVS, 3) if widow else (0,),
            "ee_pos": (PLAY_STEPS, PLAY_ENVS, 3) if widow else (0,)}
    for k, shape in want.items():
        if data[k].shape != shape:
            raise AssertionError(f"{task} play npz {k}: {data[k].shape}")
    if data["commands"].shape[:2] != (PLAY_STEPS, PLAY_ENVS):
        raise AssertionError(f"{task} play npz commands shape")
    if not all(np.isfinite(data[k]).all() for k in data.files):
        raise AssertionError(f"{task} play npz: non-finite values")
    log(f"deploy {task}: export {export_s:.2f} s (programs "
        f"{sorted(os.listdir(out_dir))}), load {load_s:.2f} s, programs vs "
        f"live model at batch 1 and {LEGGED_ENVS} max_abs_err={err:.3g}; "
        f"play --use_jit {PLAY_ENVS} envs x {PLAY_STEPS} steps "
        f"{summary['env_steps_per_s']:.0f} env-steps/s, {launches} launches, "
        f"first-batch check {summary['use_jit_max_abs_err']:.3g}")
    return dict(task=task, export_s=export_s, load_s=load_s,
                max_abs_err=err, play_env_steps_per_s=summary[
                    "env_steps_per_s"], launches=launches), launches


def update_invariant(device, envs):
    """One-epoch one-minibatch updates of the go1 MLP and of the
    go1_flat_lstm recurrent policy (its registered widths) on rows `envs`
    of one trajectory (T =
    24, 64 envs, made from a seed, so every process makes the same): the
    flattened parameters after each. Inside a process group the updates
    average over the ranks."""
    from dwbc_tpu_torch.models.actor_critic_recurrent import (
        ActorCriticRecurrent)
    from dwbc_tpu_torch.models.mlp_actor_critic import MlpActorCritic
    from dwbc_tpu_torch.rl import ppo
    from dwbc_tpu_torch.rl.recurrent import RecurrentPPO, RecurrentTransition
    from dwbc_tpu_torch.utils.task_registry import TASKS

    T, N = LEGGED_STEPS, 64
    cfg = dataclasses.replace(TASKS["go1"].ppo_cfg, num_learning_epochs=1,
                              num_mini_batches=1)
    policy = TASKS["go1_flat_lstm"].recurrent_policy
    rng = np.random.default_rng(11)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    out = []
    for recurrent in (False, True):
        torch.manual_seed(12)
        if recurrent:
            model = ActorCriticRecurrent(num_obs=48, num_actions=12,
                                         **dataclasses.asdict(policy))
            num_obs = 48
        else:
            model, num_obs = MlpActorCritic(num_obs=235, num_actions=12), 235
        obs = f32(rng.normal(size=(T, N, num_obs)))
        h0 = tuple(tuple(f32(0.5 * rng.normal(
            size=(N, policy.rnn_hidden_size))) for _ in range(2))
            for _ in range(2))
        dones = torch.as_tensor(rng.random((T, N)) < 0.1)
        dones_prev = torch.cat([torch.zeros((1, N), dtype=torch.bool),
                                dones[:-1]])
        with torch.no_grad():
            mean = (model.unroll(h0, obs, dones_prev)[1][0] if recurrent
                    else model.act_mean(obs))
            std = model.std.detach()
            actions = mean + 0.3 * std * f32(rng.normal(size=(T, N, 12)))
            logp = ppo.logp_heads(cfg, actions, mean, std)
        cols = dict(obs=obs, actions=actions,
                    rewards=f32(rng.normal(size=(T, N, 1))), dones=dones,
                    time_outs=dones & torch.as_tensor(rng.random((T, N)) < 0.5),
                    values=f32(rng.normal(size=(T, N, 1))), log_probs=logp,
                    mu=mean + 0.1 * f32(rng.normal(size=(T, N, 12))),
                    sigma=std.expand(T, N, 12).clone())
        last = f32(rng.normal(size=(N, 1)))[envs].to(device)
        model = model.to(device)
        state = ppo.PPOState(cfg, model)
        pick = lambda x: x[:, envs].to(device)
        n = last.shape[0]
        if recurrent:
            cols["dones_prev"] = dones_prev
            tr = RecurrentTransition(**{k: pick(v) for k, v in cols.items()})
            h = tuple(tuple(x[envs].to(device) for x in c) for c in h0)
            RecurrentPPO(None, model, cfg, num_steps=T).update(
                state, tr, h, last, perm=torch.arange(n, device=device))
        else:
            z6 = torch.zeros((T, N, 6))
            tr = ppo.Transition(**{k: pick(v) for k, v in dict(
                cols, target_arm_torques=z6, current_arm_dof_pos=z6,
                current_arm_dof_vel=z6).items()})
            ret, adv = ppo.compute_gae(cfg, tr, last)
            ppo.update(cfg, state, tr, ret, adv,
                       perm=torch.arange(T * n, device=device))
        out.append(torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()]).cpu().numpy())
    return out


def two_rank_worker(rank, store, out_dir, device, num_envs):
    """One of the two ranks of phase 15 (this script run with
    --two-rank-worker): go1 on its half of `num_envs` envs, then its half
    of the update invariant. Writes rank<r>.npz into out_dir."""
    from dwbc_tpu_torch.parallel import distributed as dist
    from dwbc_tpu_torch.utils import task_registry

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    device = dist.initialize(backend="gloo", device=device,
                             init_method="file://" + store)
    reset_launches()
    env, runner, _ = task_registry.make_runner(
        "go1", num_envs=num_envs, seed=1,
        log_dir=os.path.join(out_dir, "run"), device=device)
    if env.num_envs != num_envs // 2 or dist.world_size() != 2:
        raise AssertionError(f"rank {rank}: {env.num_envs} envs")
    if device.type == "cuda":
        check_kernel_shape(env)
    runner.learn(2, log_every=1)
    runner.close()
    *launches, fk_count = launch_counts()[:3]
    params = torch.cat([p.detach().reshape(-1)
                        for p in runner.model.parameters()]).cpu().numpy()
    half = slice(rank * 32, rank * 32 + 32)
    ff, rnn = update_invariant(device, half)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), params=params,
             lr=np.float64(runner.ppo_state.learning_rate),
             vx=runner.env_state.command_lin_vel_x.cpu().numpy(),
             launches=launches, fk_launches=fk_count, ff=ff, rnn=rnn)
    dist.shutdown()


def two_rank_phase(device, num_envs=LEGGED_ENVS):
    """Phase 15: two processes of this script on the one card."""
    out_dir = fresh_dir("two_rank_smoke")
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ)
    env.pop("WORLD_SIZE", None)
    t0 = time.time()
    where = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--two-rank-worker", str(r), store, out_dir,
                               where, str(num_envs)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.time() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(2)]
    if not (np.array_equal(ranks[0]["params"], ranks[1]["params"])
            and ranks[0]["lr"] == ranks[1]["lr"]
            and np.array_equal(ranks[0]["vx"], ranks[1]["vx"])):
        raise AssertionError("the two ranks' parameters, learning rate or "
                             "command range differ after training")
    run = os.path.join(out_dir, "run")
    models = sorted(f for f in os.listdir(run) if f.startswith("model_"))
    if models != ["model_2"]:
        raise AssertionError(f"checkpoints {models}")
    rows = read_metrics(run, 2)
    launches = [int(n) for r in ranks for n in r["launches"]]
    expect = 2 * LEGGED_STEPS * DECIMATION
    if device.type == "cuda":
        if launches != [expect] * 4:
            raise AssertionError(f"ranks launched the (contact, ABA) "
                                 f"kernels {launches} times")
        for r, rank in enumerate(ranks):
            check_fk(f"rank {r}", int(rank["fk_launches"]),
                     fk_launches("go1", 2 * LEGGED_STEPS))
    single = update_invariant(device, slice(0, 64))
    err = 0.0
    for i, name in enumerate(("ff", "rnn")):
        for r in ranks:
            np.testing.assert_allclose(r[name], single[i], rtol=1e-3,
                                       atol=1e-5, err_msg=name)
            err = max(err, float(np.abs(r[name] - single[i]).max()))
    for r in rows:
        log(f"two ranks x {num_envs // 2} envs (gloo, one card) go1 it "
            f"{r['it']}: collect {r['Perf/collection time']:.3f} s, learn "
            f"{r['Perf/learning_time']:.4f} s, Perf/total_fps "
            f"{r['Perf/total_fps']} (the job's {num_envs} envs)")
    log(f"two ranks: parameters bitwise equal, checkpoint and metrics from "
        f"rank 0 only, {launches} launches, {wall:.1f} s in all; sharded "
        f"one-minibatch update vs one process (MLP, LSTM) max_abs_err="
        f"{err:.3g}")
    return dict(fps=[r["Perf/total_fps"] for r in rows],
                collect_s=[r["Perf/collection time"] for r in rows],
                learn_s=[r["Perf/learning_time"] for r in rows],
                wall_s=wall, update_max_abs_err=err,
                launches=sum(launches[::2])), sum(launches[::2])


def nccl_worker(out_path, argv):
    """Phase 16's process under torchrun (this script run with
    --nccl-worker): the train CLI's main(argv); writes the kernels'
    launches in it."""
    from dwbc_tpu_torch.runner import train

    reset_launches()
    train.main(argv)
    contact, aba, fk, *_ = launch_counts()
    with open(out_path, "w") as f:
        json.dump(dict(launches=contact, aba_launches=aba, fk_launches=fk),
                  f)


def nccl_phase(single_fps):
    """Phase 16: the train CLI under torchrun, one process, NCCL:
    (results, kernel launches)."""
    log_root = fresh_dir("nccl_smoke")
    os.makedirs(log_root)
    out = os.path.join(log_root, "worker.json")
    t0 = time.time()
    # --standalone: the rendezvous takes a free local port
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", os.path.abspath(__file__), "--nccl-worker",
         out, "--task", "go1", "--num_envs", str(LEGGED_ENVS),
         "--max_iterations", "2", "--log_every", "1", "--log_root", log_root,
         "--exptid", "nccl"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if res.returncode != 0:
        raise AssertionError(f"torchrun exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    run = os.path.join(log_root, "rough_go1", "nccl")
    rows = read_metrics(run, 2)
    if "ranks=1 backend=nccl" not in res.stdout:
        raise AssertionError(f"not an NCCL group of one: "
                             f"{res.stdout[-2000:]}")
    with open(out) as f:
        counts = json.load(f)
    launches = counts["launches"]
    expect = 2 * LEGGED_STEPS * DECIMATION
    if (launches, counts["aba_launches"]) != (expect, expect):
        raise AssertionError(f"the NCCL run launched the contact kernel "
                             f"{launches} and the ABA kernel "
                             f"{counts['aba_launches']} times, expected "
                             f"{expect} each")
    check_fk("the NCCL run", counts["fk_launches"],
             fk_launches("go1", 2 * LEGGED_STEPS))
    fps = [r["Perf/total_fps"] for r in rows]
    log(f"NCCL, world size 1 (torchrun --standalone --nproc_per_node=1, "
        f"train CLI): go1 x {LEGGED_ENVS} Perf/total_fps {fps} vs "
        f"single-process {single_fps}; {launches} launches; {wall:.1f} s "
        f"with the process start")
    return dict(fps=fps, single_process_fps=single_fps, wall_s=wall,
                collect_s=[r["Perf/collection time"] for r in rows],
                learn_s=[r["Perf/learning_time"] for r in rows],
                launches=launches), launches


def cold_phase(device, n=1024):
    """Phase 17: the unfused batched step of sim/engine.py at n envs."""
    from dwbc_tpu_torch.core import urdf
    from dwbc_tpu_torch.sim import dynamics, engine
    from dwbc_tpu_torch.terrain import terrain

    m = urdf.load_urdf(urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
                       armature=0.01)
    pose = torch.tensor([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                         0.1, 0.8, -1.5] + [0.0] * 6 + [0.024, -0.024])
    q0 = torch.zeros(m.nq)
    q0[2], q0[6] = 0.42, 1.0
    q0[7:] = pose
    kp = torch.tensor([50.0] * 12 + [5.0] * 6 + [0.0] * 2)
    kd = torch.tensor([1.0] * 12 + [0.5] * 6 + [0.0] * 2)

    def run(dev, state, steps):
        hf = terrain.flat_plane(10.0, 0.5, device=dev)
        step = engine.make_batched_step(m, engine.SimParams(), hf, q0)
        inert = dynamics.default_inertial(m, dev)
        n = state.q.shape[0]
        state = engine.BodyState(q=state.q.to(dev), qd=state.qd.to(dev))
        p, a, b = pose.to(dev), kp.to(dev), kd.to(dev)
        friction = torch.ones(n, device=dev)
        for _ in range(steps):
            tau = a * (p - state.q[:, 7:]) - b * state.qd[:, 6:]
            state, con = step(state, tau, inert, friction)
        return state, con

    start = engine.BodyState(q=q0.repeat(n, 1), qd=torch.zeros((n, m.nv)))
    torch.cuda.synchronize()
    t0 = time.time()
    state, _ = run(device, start, 600)
    torch.cuda.synchronize()
    secs = time.time() - t0
    z = state.q[:, 2]
    if not bool(torch.isfinite(state.q).all()) or not bool(
            ((z > 0.24) & (z < 0.35)).all()):
        raise AssertionError(f"cold path: widowGo1 does not stand, base "
                             f"height {float(z.min()):.3f}-"
                             f"{float(z.max()):.3f} m")
    rng = np.random.default_rng(13)
    few = engine.BodyState(
        q=state.q[:4].cpu(),
        qd=state.qd[:4].cpu() + torch.as_tensor(
            0.05 * rng.normal(size=(4, m.nv)), dtype=torch.float32))
    (card, con_g), (cpu, con_c) = run(device, few, 2), run("cpu", few, 2)
    err = 0.0
    for name, a, b in (("q", card.q, cpu.q), ("qd", card.qd, cpu.qd)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4,
                                   msg=lambda s: f"cold path {name}: {s}")
        err = max(err, float((a.cpu() - b).abs().max()))
    if not bool((con_c.penetration < 0).any()):
        raise AssertionError("cold path check: no sphere in contact")
    log(f"cold path: make_batched_step widowGo1 x {n} envs, 600 substeps in "
        f"{secs:.2f} s ({secs / 600 * 1e3:.1f} ms per substep), base height "
        f"{float(z.min()):.4f}-{float(z.max()):.4f} m; card vs CPU, 4 envs x "
        f"2 substeps, max_abs_err={err:.3g}")
    return dict(num_envs=n, substeps=600, seconds=secs,
                base_height=[float(z.min()), float(z.max())],
                card_vs_cpu_max_abs_err=err)


def _cholesky_solve_spd(A, b):
    """solve_spd as the port had it before its pivot floor: LAPACK /
    cuSOLVER Cholesky, which raises on a matrix that is not positive
    definite. Only timed here, beside the current one."""
    L = torch.linalg.cholesky(A)
    if b.dim() == A.dim():
        return torch.cholesky_solve(b, L)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def repairs_phase(device, n=VARIANT_ENVS):
    """Phase 18: the three repairs on the card. solve_spd on SPD, zero-pivot
    and NaN matrices; aba with a massless env (IA[0] = 0); the heightfield
    at NaN coordinates; one widowGo1_adaptive env step at n envs with one
    env's velocities NaN (bad, reset, the others finite); and the wall
    time of one _osc_target call at n envs with the current solve_spd and
    with the Cholesky one it replaced, in turns: (results, launches)."""
    from dwbc_tpu_torch.core import maths, urdf
    from dwbc_tpu_torch.sim import dynamics
    from dwbc_tpu_torch.terrain import terrain
    from dwbc_tpu_torch.utils import task_registry

    rng = np.random.default_rng(17)
    a = rng.normal(size=(3, 6, 6))
    A = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    A[1] = np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    A[2, 4, 2] = np.nan
    b = rng.normal(size=(3, 6, 4)).astype(np.float32)
    cpu = maths.solve_spd(torch.as_tensor(A), torch.as_tensor(b))
    got = maths.solve_spd(torch.as_tensor(A, device=device),
                          torch.as_tensor(b, device=device)).cpu()
    if not (torch.isnan(got[2]).all() and torch.isfinite(got[:2]).all()):
        raise AssertionError("solve_spd on the card: NaN outside the NaN "
                             "matrix or missing in it")
    torch.testing.assert_close(got[:2], cpu[:2], rtol=1e-5, atol=0)

    m = urdf.load_urdf(urdf.WIDOW_GO1_URDF, dof_order=urdf.WIDOW_GO1_DOF_ORDER,
                       armature=0.01)
    inert = [torch.as_tensor(np.repeat(np.asarray(x, np.float32)[None], 3, 0))
             for x in (m.mass, m.com, m.inertia)]
    inert[0][1] = 0.0
    inert[2][1] = 0.0
    q = torch.zeros((3, m.nq))
    q[:, 2], q[:, 6] = 0.4, 1.0
    qd = torch.as_tensor(0.3 * rng.normal(size=(3, m.nv)), dtype=torch.float32)
    tau = torch.as_tensor(rng.normal(size=(3, m.nj)), dtype=torch.float32)
    qdd = dynamics.aba(m, dynamics.Inertial(*(x.to(device) for x in inert)),
                       q.to(device), qd.to(device), tau.to(device))[0].cpu()
    if bool(torch.isfinite(qdd[1]).any()) or not bool(
            torch.isfinite(qdd[[0, 2]]).all()):
        raise AssertionError("aba with IA[0] = 0: non-finite outside the "
                             "massless env, or finite in it")

    hf = terrain.perlin_terrain(terrain.PerlinTerrainCfg(seed=1),
                                device=device)
    x = torch.tensor([float("nan"), 1.0, float("inf"), 2.0], device=device)
    y = torch.tensor([0.5, float("nan"), 0.5, 1e20], device=device)
    h, nrm = hf.sample_with_normal(x, y)
    h3 = hf.sample_min3(x, y)
    torch.cuda.synchronize()          # a device-side assert raises here
    # a NaN coordinate gives a NaN height and its clamped cell's normal,
    # as in the reference
    if not (torch.isnan(h[:2]).all() and torch.isfinite(h[2:]).all()
            and torch.isfinite(torch.stack(nrm)).all()
            and torch.isfinite(h3).all()):
        raise AssertionError(f"heightfield at non-finite points: {h}, {h3}")

    env, _ = task_registry.make_env("widowGo1_adaptive", n, device=device)
    check_kernel_shape(env)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state, _ = env.reset(gen)
    poisoned = 5
    state.robot.qd[poisoned] = float("nan")
    actions = torch.zeros((n, env.num_actions), device=device)
    reset_launches()
    state2, out = env.step(state, actions, 3.0)
    launches = launches_since_reset("the NaN env's step", DECIMATION,
                                    fk_launches("widowGo1_adaptive", 1))
    torch.cuda.synchronize()
    others = torch.arange(n, device=device) != poisoned
    if not bool(out.reset[poisoned]) or int(out.episode_stats["term_bad"]) < 1:
        raise AssertionError("the NaN env was not marked bad and reset")
    for name, t in (("q", state2.robot.q), ("qd", state2.robot.qd),
                    ("obs", out.obs), ("rew", out.rew)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name} after the NaN env's "
                                 f"reset")
    if not bool(torch.isfinite(out.extras["target_arm_torques"][others])
                .all()):
        raise AssertionError("OSC targets non-finite outside the NaN env")

    state, _ = env.reset(gen)
    env._osc_target(state)
    call_ms = {"pivot_floor": [], "cholesky": []}
    current = maths.solve_spd
    try:
        for name in ("cholesky", "pivot_floor", "pivot_floor", "cholesky"):
            maths.solve_spd = (_cholesky_solve_spd if name == "cholesky"
                               else current)
            env._osc_target(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                env._osc_target(state)
            torch.cuda.synchronize()
            call_ms[name].append((time.perf_counter() - t0) * 100.0)
    finally:
        maths.solve_spd = current
    log(f"repairs: solve_spd (SPD, zero pivot, NaN) on the card, NaN only "
        f"in the NaN matrix, vs CPU "
        f"{float((got[:2] - cpu[:2]).abs().max()):.3g}; aba with IA[0] = 0 "
        f"non-finite in that env only; heightfield at NaN / inf / 1e20 "
        f"coordinates without a device assert; widowGo1_adaptive x {n} "
        f"step with env {poisoned}'s qd NaN: bad, reset, the rest finite, "
        f"{launches} launches; _osc_target x {n} envs ms per call, "
        f"Cholesky {call_ms['cholesky']} vs pivot floor "
        f"{call_ms['pivot_floor']}")
    return dict(osc_target_call_ms=call_ms, num_envs=n), launches


def learning_curve(iterations, task="go1_flat", train_args=()):
    """`python3 chip_smoke.py --learning-curve N [--task T] [train CLI
    flags]`: the train CLI's main() for task T (go1_flat when not given)
    for N iterations on the card, metrics every 10 iterations under
    chiprun_out/logs/<experiment>/curve[_seed<k>]. Before training, the
    kernel is held against its plain version at the env's shape. Every
    env whose physics step came out non-finite or faster than 15 m/s
    (what the env's explosion guard marks `bad`, read at the step's
    physics output) is counted. Prints the run every 50 iterations, then
    each checkpoint of the curve's entry of measure.CURVES (`curve_key`
    of T and `--ts_weight`; an unknown one raises before training) beside
    the JAX runs' values and its band, and writes
    chiprun_out/learning_curve_<key>[_seed<k>].json. Exits 1 if a value is
    out of its band (after writing everything). Refuses, before training,
    a recurrent task whose registered widths are not the JAX package's
    64-wide policy, which is all its runs trained: go1_flat_lstm trains
    legged_gym's published widths, of which the repository holds no
    curve."""
    from dwbc_tpu_torch.models.actor_critic_recurrent import (
        RecurrentPolicyCfg)
    from dwbc_tpu_torch.runner import train
    from dwbc_tpu_torch.utils import task_registry
    from dwbc_tpu_torch.utils.measure import (CURVES, compare_curves,
                                              curve_key, read_curve)

    policy = task_registry.TASKS[task].recurrent_policy
    if policy not in (None, RecurrentPolicyCfg()):
        sys.exit(f"chip_smoke: no learning curve of {task} at its widths "
                 f"({policy}); the JAX runs in measure.CURVES trained "
                 f"{RecurrentPolicyCfg()}")

    def flag(name, default=None):
        return (train_args[train_args.index(name) + 1]
                if name in train_args else default)

    seed = flag("--seed", "1")
    ts_weight = flag("--ts_weight")
    key = curve_key(task, None if ts_weight is None else float(ts_weight))
    suffix = "" if seed == "1" else f"_seed{seed}"
    blown = []
    kernel_rows = []
    make_runner = task_registry.make_runner

    def counting(task, **kw):
        setup = kw.get("env_setup")

        def env_setup(env):
            if setup is not None:
                setup(env)
            shape = check_kernel_shape(env)
            kernel_rows.extend(kernel_phase(
                env.device, [s for s in KERNEL_SHAPES if s[:3] == shape
                             and s[3]]))
            reset_launches()
            physics = env.fused_step

            @functools.wraps(physics)   # keeps its attributes (.fk)
            def counted(*args, **kwargs):
                out = physics(*args, **kwargs)
                o = out if hasattr(out, "q") else out[0]   # (out, hidden)
                bad = (~torch.isfinite(o.q).all(-1)
                       | ~torch.isfinite(o.qd).all(-1)
                       | (o.qd[:, :3].abs().amax(-1) > 15.0))
                blown.append(bad.sum())
                return out
            env.fused_step = counted

        kw["env_setup"] = env_setup
        return make_runner(task, **kw)

    task_registry.make_runner = counting
    log_root = os.path.join(OUT_DIR, "logs")
    run_dir = os.path.join(log_root, task_registry.TASKS[task].experiment_name,
                           "curve" + key[len(task):].replace("@", "_")
                           + suffix)
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.time()
    try:
        train.main(["--task", task, "--max_iterations", str(iterations),
                    "--log_root", log_root, "--log_every", "10",
                    "--exptid", os.path.basename(run_dir), *train_args])
    finally:
        task_registry.make_runner = make_runner
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launches_since_reset(
        key, None, fk_launches(task, launch_counts()[0] // DECIMATION))
    n_bad = int(torch.stack(blown).sum()) if blown else 0
    curve = read_curve(os.path.join(run_dir, "metrics.jsonl"))
    rows = [curve[it] for it in sorted(curve)]
    lacking = sorted(set(range(0, iterations, 10)) - set(curve))
    bad = [(r["it"], k) for r in rows for k, v in r.items()
           if not math.isfinite(v)]
    if lacking or bad:
        raise AssertionError(f"{task} curve: iterations {lacking} not "
                             f"logged; non-finite values {bad}")
    for r in rows:
        if r["it"] % 50 == 0 or r["it"] == rows[-1]["it"]:
            log(f"{key} it {r['it']}: " + ", ".join(
                f"{k} {r[k]:.4f}" for k in (
                    "Train/mean_reward", "Train/mean_episode_length",
                    "Train/dones", "Policy/leg_mean_noise_std",
                    "Policy/arm_mean_noise_std", "Loss/arm_torques_loss",
                    "Episode/terrain_level", "Perf/total_fps") if k in r))
    log(f"{key}: {iterations} iterations in {wall:.1f} s, {launches} "
        f"kernel launches, {n_bad} env steps with a non-finite or > 15 m/s "
        f"physics state, over {len(blown)} env steps")
    verdicts = []
    spec = CURVES[key]
    for checkpoints, keys in spec["checks"]:
        verdicts += compare_curves(
            rows, [os.path.join(ROOT, p) for p in spec["runs"]],
            [c for c in checkpoints if c < iterations], keys)
    for v in verdicts:
        if v["missing"]:
            where = [m if m == "port" else os.path.relpath(m, ROOT)
                     for m in v["missing"]]
            log(f"{key} it {v['it']} {v['key']}: missing in "
                f"{', '.join(where)}: OUT")
            continue
        what = (f" ({v['channel']}, JAX {'/'.join(v['jax_channels'])})"
                if "channel" in v else "")
        log(f"{key} it {v['it']} {v['key']}{what}: port {v['port']:.4f}, "
            f"JAX {', '.join(f'{x:.4f}' for x in v['jax'])}, band "
            f"[{v['band'][0]:.4f}, {v['band'][1]:.4f}]: "
            f"{'in' if v['ok'] else 'OUT'}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"learning_curve_{key}{suffix}.json"),
              "w") as f:
        json.dump(dict(card=card(), task=task, curve=key,
                       train_args=list(train_args),
                       iterations=iterations, wall_s=wall,
                       kernel_launches=launches, bad_env_steps=n_bad,
                       env_steps=len(blown), kernel_rows=kernel_rows,
                       verdicts=verdicts, rows=rows), f, indent=1)
    out = [v for v in verdicts if not v["ok"]]
    log(f"{key}: {len(verdicts) - len(out)} of {len(verdicts)} checks in "
        f"their bands")
    if out:
        sys.exit(1)


def main():
    if sys.argv[1:2] == ["--two-rank-worker"]:
        sys.path.insert(0, ROOT)
        two_rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                        sys.argv[5], int(sys.argv[6]))
        return
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.path.insert(0, ROOT)
        nccl_worker(sys.argv[2], sys.argv[3:])
        return
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--learning-curve"]:
        rest = sys.argv[3:]
        task = "go1_flat"
        if rest[:1] == ["--task"]:
            task, rest = rest[1], rest[2:]
        learning_curve(int(sys.argv[2]), task, rest)
        return
    from dwbc_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = card()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    build_phase()
    rows = kernel_phase(device)
    aba_rows = aba_phase(device)
    fk_rows = fk_phase(device)
    lstm_rows = lstm_phase(device)
    step_check(device)
    collects, launches = slice_phase(device, profile)
    training, n = train_phase(device, profile)
    launches += n
    update_err = update_check(device)
    bf16_err, bf16_store_diff = bf16_update_check(device)
    variants = []
    for width in (VARIANT_ENVS, NUM_ENVS) if profile else (VARIANT_ENVS,):
        variant, n = variant_train(device, width)
        variants.append(variant)
        launches += n
    osc_err, osc_ms = osc_check(device, profile)

    legged = []
    result, n = legged_phase(device, profile)
    legged.append(result)
    launches += n
    legged_step_err = legged_step_check(device)
    result, n = actuator_phase(device)
    legged.append(result)
    launches += n
    recurrent, n = recurrent_phase(device)
    launches += n
    recurrent_err = recurrent_update_check(device)
    for task in ("cassie", "a1", "anymal_b"):
        _, _, _, result = legged_train(device, task, 1)
        legged.append(result)
        launches += result["launches"]

    t0 = time.time()
    deploy = []
    for task, run in (("go1", "go1_smoke"), ("widowGo1", "train_smoke")):
        result, n = deploy_phase(device, task,
                                 os.path.join(OUT_DIR, run, "model_3"))
        deploy.append(result)
        launches += n
    two_rank, n = two_rank_phase(device)
    launches += n
    nccl, n = nccl_phase(legged[0]["fps"])
    launches += n
    cold = cold_phase(device)
    log(f"phases 14-17 (export -> play, two ranks, NCCL, cold path): "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    repairs, n = repairs_phase(device)
    launches += n
    log(f"phase 18 (repairs): {time.time() - t0:.1f} s")

    drop_checkpoints()
    main_row = rows[0]
    kernels = [dict(
        name="contact_law", route="cuda",
        source="dwbc_tpu_torch/csrc/contact_law.cu",
        replaces="dwbc_tpu/ops/contact_pallas.py:43",
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, share_of_bound=main_row["share_of_bound"],
        shapes=[{k: r[k] for k in ("ng", "nb", "n", "sorted", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "share_of_bound", "max_abs_err")}
                for r in rows])]
    # every main-path phase counted the ABA kernel's launches beside the
    # contact kernel's and held the two equal (launches_since_reset)
    aba_row = aba_rows[0]
    kernels.append(dict(
        name="aba", route="cuda", source="dwbc_tpu_torch/csrc/aba.cu",
        replaces=None, launches=launches,
        max_rel_err=max(r["max_rel_err"] for r in aba_rows),
        pivot_floor_rel_err=max(r["pivot_floor_rel_err"] for r in aba_rows),
        ms=aba_row["ms"], plain_ms=aba_row["plain_ms"],
        bound_ms=aba_row["bound_ms"], bound_by=aba_row["bound_by"],
        library_ms=None, share_of_bound=aba_row["share_of_bound"],
        shapes=[{k: r[k] for k in ("tree", "nb", "n", "ms", "plain_ms",
                                   "host_us", "plain_host_us", "bound_ms",
                                   "share_of_bound", "max_rel_err",
                                   "pivot_floor_rel_err")}
                for r in aba_rows]))
    # every main-path phase held the FK kernel's launches to fk_launches
    fk_row = fk_rows[0]
    kernels.append(dict(
        name="fk", route="cuda", source="dwbc_tpu_torch/csrc/fk.cu",
        replaces=None, launches=FK_CHECKED[0],
        max_rel_err=max(r["max_rel_err"] for r in fk_rows),
        ms=fk_row["ms"], plain_ms=fk_row["plain_ms"],
        bound_ms=fk_row["bound_ms"], bound_by=fk_row["bound_by"],
        library_ms=None, share_of_bound=fk_row["share_of_bound"],
        shapes=[{k: r[k] for k in ("tree", "nb", "n", "with_qd", "ms",
                                   "plain_ms", "host_us", "plain_host_us",
                                   "bound_ms", "share_of_bound",
                                   "max_rel_err", "differing_entries")}
                for r in fk_rows]))
    # the recurrent phase held the LSTM kernels' launches to one a step
    # of every unroll, each way
    lstm_row = lstm_rows[0]
    for kind in ("forward", "backward"):
        k = lstm_row[kind]
        kernels.append(dict(
            name=f"lstm_{kind}", route="cuda",
            source="dwbc_tpu_torch/csrc/lstm.cu", replaces=None,
            launches=LSTM_CHECKED[0],
            max_rel_err=max(max(r["rel_err"].values()) for r in lstm_rows),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            share_of_bound=k["share_of_bound"],
            shapes=[dict(m=r["m"], b=r["b"], h=r["h"], **r[kind])
                    for r in lstm_rows]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, kernel_rows=rows,
                       aba_rows=aba_rows, fk_rows=fk_rows,
                       lstm_rows=lstm_rows,
                       collects=collects, training=training,
                       update_check_max_abs_err=update_err,
                       bf16_update_check=dict(
                           max_abs_err=bf16_err,
                           store_vs_float32_max_abs_diff=bf16_store_diff),
                       variants=variants, osc_check_max_abs_err=osc_err,
                       osc_target_call_ms=osc_ms, legged=legged,
                       legged_step_check_max_abs_err=legged_step_err,
                       recurrent=recurrent,
                       recurrent_update_check=recurrent_err,
                       deploy=deploy, two_rank=two_rank, nccl=nccl,
                       cold_path=cold, repairs=repairs),
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run uses one card, whatever else the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
