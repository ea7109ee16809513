"""The port's spans and counters (dwbc_tpu_torch/utils/spans.py) on the
training path, on the CPU: how often each span runs in an iteration of
go1 and of widowGo1, the runner's timers read from its spans, the ring
of records and the set-up record, the profiler's view of the spans, and
the host-synchronisation counter at each of its sites."""

import json
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dwbc_tpu_torch.utils import device as device_lib
from dwbc_tpu_torch.utils import spans, task_registry

ENVS, STEPS = 4, 2
SIM = ("sim.fk", "sim.contact", "sim.aba", "sim.integrate")
PER_STEP = ("rollout.policy", "env.physics", "env.post")


@pytest.fixture(scope="module", autouse=True)
def quiet_host():
    """One torch thread (the tensors are tiny) and no TensorFlow, which
    TensorBoard's writer would import for many seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    """{task: (env, runner)} at ENVS x STEPS, built after a reset of the
    records, with the set-up record they left."""
    spans.reset()
    out = {}
    for task in ("go1", "widowGo1"):
        env, runner, _ = task_registry.make_runner(task, num_envs=ENVS,
                                                   seed=2, device="cpu")
        runner.rollout.num_steps = STEPS
        out[task] = (env, runner)
    setup = spans.setup_record()["spans"]
    return out, {k: list(v) for k, v in setup.items()}


def _learn(runner, n=1):
    """Records of `n` iterations of runner.learn."""
    spans.reset()
    runner.learn(n)
    recs = spans.records()
    assert len(recs) == n
    return recs


@pytest.mark.parametrize("task", ["go1", "widowGo1"])
def test_spans_run_once_per_substep_step_and_minibatch(built, task):
    env, runner = built[0][task]
    cfg = runner.cfg
    minibatches = cfg.num_learning_epochs * cfg.num_mini_batches
    it0 = runner.it
    for rec in _learn(runner, 2):
        calls = {k: v[0] for k, v in rec["spans"].items()}
        for name in SIM:
            assert calls[name] == env.cfg.control.decimation * STEPS, name
        for name in PER_STEP:
            assert calls[name] == STEPS, name
        assert calls["runner.collect"] == calls["runner.learn"] == 1
        dagger = cfg.use_dagger and rec["it"] % cfg.dagger_update_freq == 0
        if dagger:
            assert calls["ppo.dagger_minibatch"] == minibatches
            assert "ppo.minibatch" not in calls and "ppo.gae" not in calls
        else:
            assert calls["ppo.minibatch"] == minibatches
            assert calls["ppo.gae"] == 1
        assert rec["profiled"] is False
        assert not any(k.startswith("setup.") for k in calls)
        # the physics spans nest inside the env's, the env's inside the
        # collect: no inner total exceeds its outer one
        ns = {k: v[1] for k, v in rec["spans"].items()}
        assert sum(ns[k] for k in SIM) <= ns["env.physics"]
        assert sum(ns[k] for k in PER_STEP) <= ns["runner.collect"]
    assert [r["it"] for r in spans.records()] == [it0, it0 + 1]


@pytest.mark.parametrize("task", ["go1", "widowGo1"])
def test_runner_timers_are_its_spans(built, task):
    _, runner = built[0][task]
    rec, = _learn(runner)
    assert runner.last_collection_time == \
        rec["spans"]["runner.collect"][1] * 1e-9
    assert runner.last_learn_time == rec["spans"]["runner.learn"][1] * 1e-9


def test_set_up_spans_go_to_the_set_up_record(built):
    setup = built[1]
    assert setup["setup.env"][0] == setup["setup.runner"][0] == 2
    spans.reset()
    with spans.span("setup.env") as outer:
        with spans.span("setup.native"):
            pass
    spans.begin_iteration(0)
    with spans.span("setup.native") as inside:
        pass
    with spans.span("runner.collect"):
        pass
    spans.end_iteration()
    rec = spans.setup_record()
    assert rec["spans"]["setup.native"][0] == 2
    # the nested setup.native is counted once, in setup.env's time
    assert rec["top_ns"] == outer.ns + inside.ns
    assert set(spans.records()[0]["spans"]) == {"runner.collect"}


def test_the_ring_keeps_the_newest_records():
    spans.reset()
    for it in range(spans.RING + 6):
        spans.begin_iteration(it)
        spans.count("host_sync", it)
        spans.end_iteration()
    recs = spans.records()
    assert len(recs) == spans.RING == 64
    assert [r["it"] for r in recs] == list(range(6, spans.RING + 6))
    assert recs[-1]["counters"] == {"host_sync": spans.RING + 5}
    # outside an iteration a span is timed and kept nowhere
    with spans.span("env.post") as s:
        pass
    assert s.ns > 0 and len(spans.records()) == spans.RING


def test_no_record_function_without_a_profiler(built, monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, runner = built[0]["go1"]
    rec, = _learn(runner)
    assert rec["spans"]["sim.fk"][0] > 0 and rec["profiled"] is False


def _annotations(prof):
    """(name, start, end) of the profile's user annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = (e.activity_type() if hasattr(e, "activity_type") else
                "user_annotation" if e.is_user_annotation() else "other")
        if kind == "user_annotation":
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def test_spans_land_on_the_profilers_clock(built):
    _, runner = built[0]["widowGo1"]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.window"):
            runner.learn(1)
    rec, = spans.records()
    assert rec["profiled"] is True
    notes = _annotations(prof)
    window = [n for n in notes if n[0] == "test.window"]
    assert len(window) == 1
    lo, hi = window[0][1:]
    program = [n for n in notes if n[0] in rec["spans"]]
    calls = {}
    for name, s, e in program:
        assert lo <= s <= e <= hi, name
        calls[name] = calls.get(name, 0) + 1
    assert calls == {k: v[0] for k, v in rec["spans"].items()}

    def inside(inner, outer):
        outs = [n for n in program if n[0] == outer]
        return all(any(o[1] <= i[1] and i[2] <= o[2] for o in outs)
                   for i in program if i[0] == inner)
    for name in SIM:
        assert inside(name, "env.physics")
    for name in PER_STEP:
        assert inside(name, "runner.collect")
    assert inside("ppo.minibatch", "runner.learn")


@pytest.fixture
def as_if_on_card(monkeypatch):
    """Every tensor and device counts as the card's, and the runner's
    device synchronisation does nothing: the counter runs on the CPU."""
    monkeypatch.setattr(device_lib, "on_card", lambda x: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_host_syncs_are_counted_only_on_the_card(built):
    _, runner = built[0]["go1"]
    rec, = _learn(runner)
    assert rec["counters"] == {}


@pytest.mark.parametrize("task,per_iteration", [
    # the runner's two synchronisations, the adaptive KL's .item() of
    # each of 5 x 4 minibatches, the std floor's copy to the card
    ("go1", 2 + 20 + 1),
    # the runner's two, the std floor's copy, and per env step the goal
    # resample's two bounds (at expiry and at reset), the observations'
    # command scale, the rewards' gravity vector and two list indices
    ("widowGo1", 2 + 1 + STEPS * (2 * 2 + 1 + 3)),
])
def test_each_sync_site_counts_once(built, as_if_on_card, task,
                                    per_iteration):
    _, runner = built[0][task]
    runner.it = 2          # a PPO iteration, not logged
    rec, = _learn(runner)
    assert rec["counters"]["host_sync"] == per_iteration


def test_the_log_line_carries_the_spans_and_syncs(built, as_if_on_card,
                                                  tmp_path):
    _, runner = built[0]["go1"]
    runner.it = 2
    spans.reset()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        runner._log_f = f
        try:
            runner.learn(1, log_every=1)
        finally:
            runner._log_f = None
    rec, = spans.records()
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    # the logged iteration adds the log's own read of the device values
    assert line["Perf/host_syncs"] == rec["counters"]["host_sync"] == 24
    for name, (_, ns) in rec["spans"].items():
        assert line["Perf/span/" + name] == ns * 1e-9
