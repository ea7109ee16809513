"""Training-throughput benchmark of the port on one GPU.

    python -m dwbc_tpu_torch.bench                      # widowGo1, 8192 envs
    python -m dwbc_tpu_torch.bench --task widowGo1,go1,go1_flat_lstm
    python -m dwbc_tpu_torch.bench --cpu --task go1 --num_envs 16 --steps 2

The port's counterpart of the root bench.py, which stays the JAX
package's harness. It measures what bench.py measures, with bench.py's
formulas: Perf/total_fps = steps x envs x iterations / wall seconds of a
window of training iterations, its collect / learn split, the state
bytes an env step moves against the card's HBM rate, and the model's
operations against its float32 rate; and beside them the contact
kernel's time per launch at the task's shape against its plain version
and its bound.

Each task's runner is built once through task_registry.make_runner and
warmed up. The timed windows then run interleaved: for every repeat each
task in turn runs `iters` iterations, so that noise on the shared host
falls on all tasks alike. OnPolicyRunner tasks run OnPolicyRunner.learn
one iteration at a time (its own collect / learn split); the recurrent
task runs RecurrentPPO.collect and update as RecurrentRunner.learn calls
them, timed apart with the card synchronised around each.

The last line of standard output is one JSON object: the first task's
numbers under bench.py's keys, every task under `tasks`, the card under
`device`. It runs on `cuda` unless --cpu is given, and raises without a
card. On the CPU every device metric (HBM and float32 shares, kernel
times, the power limit) is null: a CPU timing never stands under a
device metric's name. bench.py's vs_baseline is left out: its anchor is
a TPU number.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import time
from typing import List, Optional

import torch
from torch import nn

from .utils import measure

# bench.py's default width for its task (DWBC_BENCH_ENVS); the other
# tasks run at their registry default
DEFAULT_ENVS = {"widowGo1": 8192}
# the JAX state holds an int32 step counter and a uint32[2] random key
# where the port holds a Python or int64 counter and a torch.Generator:
# they count as the JAX state holds them, so that the two packages'
# formulas read the same state
_JAX_SCALAR_BYTES = {"common_step": 4, "generator": 8}


def _tensor_leaves(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensor_leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensor_leaves(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensor_leaves(getattr(x, f.name))


def state_nbytes(state) -> int:
    """Bytes of every leaf of an env state (bench.py sums the JAX state's
    leaves the same way)."""
    total = 0
    for f in dataclasses.fields(state):
        if f.name in _JAX_SCALAR_BYTES:
            total += _JAX_SCALAR_BYTES[f.name]
        else:
            total += sum(t.nbytes for t in _tensor_leaves(getattr(state,
                                                                  f.name)))
    return total


def bytes_per_env_step(state, decimation: int) -> float:
    """bench.py's analytic state traffic of one env step, all envs: each
    substep reads and writes the leaves it carries (robot q / qd, the box
    q / qd where there is one, the contact carry), and the step reads and
    writes the whole state once."""
    substep = [state.robot.q, state.robot.qd]
    if hasattr(state, "box"):
        substep += [state.box.q, state.box.qd]
    substep += list(_tensor_leaves(state.contact_carry))
    substep_bytes = sum(t.nbytes for t in substep)
    return 2.0 * substep_bytes * decimation + 2.0 * state_nbytes(state)


def forward_flops(model: nn.Module) -> int:
    """Operations of one row through model.forward, which is what a
    collect step runs once per env: 2 x in x out for every Linear on the
    way (the recurrent policy's gate matrices are Linears). The history
    encoder of the dual-head ActorCritic runs only in DAgger iterations
    (every dagger_update_freq-th), not in the PPO iterations counted
    here. A count from the layer widths, independent of how the port
    computes them."""
    actor = getattr(model, "actor", None)
    hist = getattr(actor, "history_encoder", None)
    skip = {id(m) for m in hist.modules()} if hist is not None else set()
    return sum(2 * m.in_features * m.out_features for m in model.modules()
               if isinstance(m, nn.Linear) and id(m) not in skip)


def flops_per_iteration(model: nn.Module, num_envs: int, steps: int,
                        epochs: int) -> int:
    """A PPO iteration's model operations: one forward per env per
    collect step, and forward + backward (3 forwards) per trajectory row
    in each learning epoch."""
    return forward_flops(model) * num_envs * steps * (1 + 3 * epochs)


def _median(xs):
    return statistics.median(xs) if xs else None


class TaskBench:
    """One task's runner and what its timed windows measured."""

    def __init__(self, task: str, num_envs: Optional[int],
                 steps: Optional[int], seed: int, device: torch.device):
        from .rl.recurrent import RecurrentRunner
        from .utils.task_registry import TASKS, make_runner

        self.task = task
        self.num_envs = num_envs or DEFAULT_ENVS.get(
            task, TASKS[task].default_num_envs)
        self.device = device
        self.env, self.runner, spec = make_runner(
            task, num_envs=self.num_envs, seed=seed, device=device)
        self.steps = steps or spec.num_steps_per_env
        self.epochs = spec.ppo_cfg.num_learning_epochs
        self.recurrent = isinstance(self.runner, RecurrentRunner)
        if self.recurrent:
            self.runner.alg.num_steps = self.steps
        else:
            self.runner.rollout.num_steps = self.steps
        self.windows: List[float] = []      # wall seconds of each window
        self.iters: List[int] = []
        self.collect_s: List[float] = []    # per timed iteration
        self.learn_s: List[float] = []
        self.launches = 0                   # contact kernel, timed windows
        self._last = None                   # the recurrent learn step's input

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def iteration(self):
        """One training iteration as the runner's learn runs it:
        (collect seconds, learn seconds)."""
        r = self.runner
        if not self.recurrent:
            r.learn(1, log_every=10 ** 9)
            return r.last_collection_time, r.last_learn_time
        h0 = r.carry
        self._sync()
        t0 = time.perf_counter()
        (r.env_state, r.obs, r.carry, r.last_dones, traj, last_values,
         _, _) = r.alg.collect(r.env_state, r.obs, r.carry, r.last_dones,
                               r.noise_gen)
        self._sync()
        t1 = time.perf_counter()
        r.alg.update(r.ppo_state, traj, h0, last_values, r.perm_gen)
        self._sync()
        self._last = (traj, h0, last_values)
        return t1 - t0, time.perf_counter() - t1

    def warmup(self, iters: int):
        for _ in range(iters):
            self.iteration()

    def window(self, iters: int):
        """`iters` timed iterations, host clock around them with the card
        synchronised at both ends."""
        from .ops.contact_kernel import contact_law

        before = contact_law.launches
        self._sync()
        t0 = time.perf_counter()
        splits = [self.iteration() for _ in range(iters)]
        self._sync()
        self.windows.append(time.perf_counter() - t0)
        self.iters.append(iters)
        self.launches += contact_law.launches - before
        self.collect_s += [c for c, _ in splits]
        self.learn_s += [l for _, l in splits]

    def fps_runs(self):
        return [self.steps * self.num_envs * n / dt
                for n, dt in zip(self.iters, self.windows)]

    def env_step(self):
        """One env step from the runner's state with the policy's mean
        actions (state and runner unchanged)."""
        r = self.runner
        with torch.no_grad():
            if self.recurrent:
                _, actions, _ = r.model.step(r.carry, r.obs)
                return self.env.step(r.env_state, actions)
            actions = r.model.act_mean(r.obs)
            if r.rollout.has_counter:
                return self.env.step(r.env_state, actions, float(r.it))
            return self.env.step(r.env_state, actions)

    def learn_step(self):
        """One PPO (or recurrent) learn step on the newest trajectory."""
        r = self.runner
        if self.recurrent:
            traj, h0, last_values = self._last
            return r.alg.update(r.ppo_state, traj, h0, last_values,
                                r.perm_gen)
        return r.rollout.learn_step(r.ppo_state, r.last_traj, r.obs,
                                    r.perm_gen, dagger=False)

    def kernel_row(self):
        """The contact kernel at this task's shape: launches per timed
        iteration; on the card its ms per launch and its plain version's
        (CUDA graphs over random inputs, measure.device_ms), the bound and
        the share of it."""
        from .ops.contact_kernel import contact_law
        from .sim.contact import fused_terrain_law

        ng, nb, n = (len(self.env.model.geom_body), self.env.model.nb,
                     self.env.num_envs)
        bound_ms, bound_by = measure.law_bound_ms(ng, n)
        row = dict(shape=[ng, nb, n],
                   launches_per_iter=self.launches / max(sum(self.iters), 1),
                   ms=None, plain_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=None)
        if self.device.type == "cuda":
            counted = contact_law.launches   # timing launches do not count
            sets = [measure.random_scene(n, ng, nb, seed=1000 * ng + n + i,
                                         device=self.device)
                    for i in range(measure.N_SETS)]
            row["ms"] = measure.device_ms(contact_law, sets,
                                          measure.TIMED_LAUNCHES)
            row["plain_ms"] = measure.device_ms(fused_terrain_law, sets,
                                                measure.PLAIN_LAUNCHES)
            row["share_of_bound"] = bound_ms / row["ms"]
            contact_law.launches = counted
        return row

    def result(self):
        """The task's line: bench.py's keys and the port's additions."""
        on_card = self.device.type == "cuda"
        runs = self.fps_runs()
        coll = _median(self.collect_s)
        ips = _median([n / dt for n, dt in zip(self.iters, self.windows)])
        traffic = (bytes_per_env_step(self.runner.env_state,
                                      self.env.cfg.control.decimation)
                   * self.steps)
        gbps = traffic / coll / 1e9 if on_card else None
        flops = flops_per_iteration(self.runner.model, self.num_envs,
                                    self.steps, self.epochs)
        return {
            "task": self.task,
            "metric": f"{self.task}_train_total_fps",
            "value": _median(runs),
            "unit": "env-steps/s",
            "num_envs": self.num_envs,
            "steps": self.steps,
            "iters": self.iters[0] if self.iters else 0,
            "runs": runs,
            "min": min(runs) if runs else None,
            "max": max(runs) if runs else None,
            "samples": len(runs),
            "collection_time_s": coll,
            "learn_time_s": _median(self.learn_s),
            "collect_s_runs": self.collect_s,
            "learn_s_runs": self.learn_s,
            "iters_per_s": ips,
            "state_bytes_per_env_step": traffic / self.steps / self.num_envs,
            "collect_hbm_gbps": gbps,
            "hbm_util_vs_peak": (gbps * 1e9 / measure.HBM_BYTES_PER_S
                                 if on_card else None),
            "model_flops_per_iter": flops,
            "mfu_vs_f32_peak": (flops * ips / measure.FP32_FLOPS
                                if on_card else None),
            "contact_kernel": self.kernel_row(),
        }


def _trace(bench: TaskBench, out_dir: str):
    """torch.profiler over one env step and one learn step: the Chrome
    trace in out_dir, and on the card the device-busy share of that
    window and its ten longest device operations."""
    from torch.profiler import ProfilerActivity, profile

    on_card = bench.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    bench._sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bench.env_step()
        bench.learn_step()
        bench._sync()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{bench.task}_step_learn.json")
    prof.export_chrome_trace(path)
    out = dict(file=path, task=bench.task, wall_s=wall,
               device_busy_s=None, device_busy_share=None,
               top_device_ops=None)
    if on_card:
        rows = measure.device_kernel_rows(prof.key_averages())
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        out.update(device_busy_s=busy, device_busy_share=busy / wall,
                   top_device_ops=[[e.key, e.count,
                                    e.self_device_time_total / 1e3]
                                   for e in rows[:10]])
    return out


def _sweep(task, n0, fps0, args, device):
    """{envs: fps} of one timed window of `task` at each --sweep width
    (the main run's median at its own width), one runner at a time."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fps = {}
    for n in (int(x) for x in args.sweep.split(",")):
        if n == n0:
            fps[str(n)] = fps0
            continue
        b = TaskBench(task, n, args.steps, args.seed, device)
        b.warmup(args.warmup)
        b.window(args.iters)
        fps[str(n)] = b.fps_runs()[0]
        del b
        gc.collect()
    return fps


def _device_entry(device: torch.device):
    if device.type != "cuda":
        return dict(platform="cpu", name="cpu", power_limit_w=None, count=1)
    c = measure.card(device.index or 0)
    return dict(platform="gpu", name=c.name, power_limit_w=c.power_limit_w,
                count=torch.cuda.device_count(), nvidia_smi=c.smi)


def parse_args(argv=None):
    env = os.environ.get
    trace = env("DWBC_BENCH_TRACE") or None
    if trace == "1":        # bench.py's switch and directory
        trace = os.path.join("logs", "profile")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="widowGo1",
                    help="comma-separated task names")
    ap.add_argument("--num_envs", type=int,
                    default=int(env("DWBC_BENCH_ENVS", 0)) or None,
                    help="envs of every task (default: widowGo1 8192, the "
                         "others their registry default)")
    ap.add_argument("--steps", type=int,
                    default=int(env("DWBC_BENCH_STEPS", 0)) or None,
                    help="steps per env and iteration (default: the task's)")
    ap.add_argument("--iters", type=int,
                    default=int(env("DWBC_BENCH_ITERS", 3)),
                    help="iterations per timed window")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed iterations per task first")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed windows per task, interleaved across tasks")
    ap.add_argument("--sweep", default=env("DWBC_BENCH_SWEEP", ""),
                    help="comma-separated env counts for the first task")
    ap.add_argument("--trace", default=trace, metavar="DIR",
                    help="profile one env step and one learn step of the "
                         "first task into DIR")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the benchmark; prints its JSON line last and returns it as a
    dict."""
    from .utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    tasks = [t for t in args.task.split(",") if t]
    benches = [TaskBench(t, args.num_envs, args.steps, args.seed, device)
               for t in tasks]
    for b in benches:
        b.warmup(args.warmup)
    for _ in range(args.repeats):
        for b in benches:
            b.window(args.iters)
    results = [b.result() for b in benches]
    out = {k: v for k, v in results[0].items() if k != "task"}
    out["tasks"] = results
    out["device"] = _device_entry(device)
    if args.trace:
        out["trace"] = _trace(benches[0], args.trace)
    if args.sweep:
        first, n0 = benches[0].task, benches[0].num_envs
        del benches
        out["sweep"] = _sweep(first, n0, results[0]["value"], args, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
