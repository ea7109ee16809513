"""The readers of the program's own spans and counters
(benchmark/program_spans.py and the seven metrics that use it), on
records built by hand."""

import pytest

from benchmark import cells, program_spans

SPAN_READERS = {"rollout.policy_host_ms_per_step": "rollout.policy",
                "sim.fk_host_ms_per_step": "sim.fk",
                "sim.contact_host_ms_per_step": "sim.contact",
                "sim.aba_host_ms_per_step": "sim.aba",
                "env.post_host_ms_per_step": "env.post"}
READERS = list(SPAN_READERS) + ["host.syncs_per_iteration", "setup.build_s"]


def _record(it, collect_ns, profiled=False, scale=1, syncs=2):
    spans = {"runner.collect": [1, collect_ns],
             "runner.learn": [1, 1_000_000]}
    for k, name in enumerate(SPAN_READERS.values()):
        spans[name] = [4, (k + 1) * 1_000_000 * scale]
    return {"it": it, "profiled": profiled, "spans": spans,
            "counters": {"host_sync": syncs}}


def _setup():
    return {"spans": {"setup.env": [1, 3_000_000_000],
                      "setup.native": [2, 500_000_000],
                      "setup.runner": [1, 1_000_000_000]},
            "top_ns": 4_250_000_000}


def _history():
    # three set-up iterations, a window of two (scale 10 and 20, one of
    # them logged: 3 syncs), then the two traced iterations
    return [_record(0, 5e9), _record(1, 4e9), _record(2, 4e9),
            _record(3, 2e9, scale=10), _record(4, 3e9, scale=20, syncs=3),
            _record(5, 9e9, profiled=True, scale=99),
            _record(6, 9e9, profiled=True, scale=99)]


def _rec(iterations=2, steps=80, collect_s=5.0):
    return {"window": {"seconds": 6.0, "iterations": iterations,
                       "steps": steps, "collect_s": collect_s,
                       "learn_s": 0.002, "env_steps": 1, "flops": 1}}


@pytest.fixture
def program(monkeypatch):
    def use(records, setup=None):
        monkeypatch.setattr(program_spans, "program_records",
                            lambda: (records, setup or _setup()))
    return use


def test_the_window_is_the_last_unprofiled_records(program):
    program(_history())
    picked = program_spans.window_records(_rec())
    assert [r["it"] for r in picked] == [3, 4]


def test_span_readers_divide_by_the_window_steps(program):
    program(_history())
    rec = _rec()
    for k, (metric, name) in enumerate(SPAN_READERS.items()):
        # (k + 1) ms x (10 + 20) over 80 steps
        want = (k + 1) * 30 / 80
        assert cells.reader(metric)(rec) == pytest.approx(want)
        assert program_spans.span_ms_per_step(rec, name) == \
            pytest.approx(want)


def test_syncs_per_iteration_and_setup_seconds(program):
    program(_history())
    assert cells.reader("host.syncs_per_iteration")(_rec()) == 2.5
    # the nested setup.native is not counted twice: top_ns alone
    assert cells.reader("setup.build_s")(_rec()) == pytest.approx(4.25)


def test_nothing_without_the_span_module(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    for name in READERS:
        assert cells.reader(name)(_rec()) is None


def test_nothing_without_enough_records(program):
    program([])
    for name in READERS[:-1]:
        assert cells.reader(name)(_rec()) is None
    program(_history()[:4] + _history()[5:])   # one window record only
    for name in READERS[:-1]:
        assert cells.reader(name)(_rec()) is None
    program(_history(), {"spans": {}, "top_ns": 0})
    assert cells.reader("setup.build_s")(_rec()) is None


def test_nothing_when_the_records_are_not_the_window(program):
    program(_history())
    # collect seconds of records 3 and 4 are 5.0; a window of other
    # iterations, or of another length, does not match
    for rec in (_rec(collect_s=5.0 * (1 + 1e-5)), _rec(collect_s=8.0),
                _rec(iterations=3)):
        for name in READERS[:-1]:
            assert cells.reader(name)(rec) is None
    assert cells.reader("sim.fk_host_ms_per_step")(
        _rec(collect_s=5.0 * (1 + 1e-7))) is not None


def test_nothing_for_a_span_the_window_lacks(program):
    records = _history()
    for r in records:
        del r["spans"]["sim.aba"]
        del r["counters"]["host_sync"]
    program(records)
    assert cells.reader("sim.aba_host_ms_per_step")(_rec()) is None
    assert cells.reader("host.syncs_per_iteration")(_rec()) is None
    assert cells.reader("sim.fk_host_ms_per_step")(_rec()) is not None


def test_the_program_module_is_read_when_present():
    from dwbc_tpu_torch.utils import spans
    spans.reset()
    got = program_spans.program_records()
    assert got == ([], spans.setup_record())
