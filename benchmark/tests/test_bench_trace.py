"""The reduction of a traced iteration: busy and idle time, the readers
of the device metrics, and the breakdown's labels, on records built by
hand."""

import pytest

from benchmark import cells, trace


def _records():
    # a 100 ns iteration: two overlapping kernels, a memcpy, the contact
    # kernel twice; host spans env.step (with an op) and learn_step
    device = [("gemm", 10, 30, "kernel"), ("gemm", 20, 40, "kernel"),
              ("Memcpy HtoD", 50, 55, "gpu_memcpy"),
              ("void contact_law_kernel<92, 13>(float*)", 60, 64, "kernel"),
              ("void contact_law_kernel<92, 13>(float*)", 70, 76, "kernel")]
    spans = [("env.step", 0, 58), ("learn_step", 58, 100),
             ("policy.act", 80, 90)]
    ops = [("aten::index", 40, 50, 1), ("aten::mm", 80, 85, 1),
           ("autograd::engine", 86, 99, 2)]
    return {"window": (0, 100), "device": device, "spans": spans, "ops": ops}


def test_marker_kernels_bound_the_device_only_window():
    marks = [("fill", 5, 6, "kernel"), ("fill", 98, 100, "kernel")]
    window, device = trace.between_marks(marks[:1] + _records()["device"]
                                         + marks[1:])
    assert window == (5, 100)
    assert device == _records()["device"]
    with pytest.raises(RuntimeError):
        trace.between_marks(marks[:1])


def test_busy_time_is_the_union_of_device_operations():
    assert trace.busy_ns(_records()) == 30 + 5 + 4 + 6


def test_device_readers():
    prof = _records()
    rec = {"profile": prof, "profile_steps": 2, "contact_shape": (92, 4096)}
    assert cells.reader("device.idle_share")(rec) == pytest.approx(55.0)
    assert cells.reader("device.kernels_per_env_step")(rec) == 2.0
    from benchmark import yardstick
    bound_ms, _ = yardstick.law_bound_ms(92, 4096)
    got = cells.reader("contact_law_kernel_roofline")(rec)
    assert got == pytest.approx(bound_ms / 5e-6 * 100)


def test_readers_return_nothing_without_their_records():
    rec = {"profile": None, "profile_steps": 0, "contact_shape": (92, 4096),
           "window": {"seconds": 0.0, "iterations": 0, "steps": 0,
                      "collect_s": 0.0, "learn_s": 0.0, "flops": 0}}
    for name in ("device.idle_share", "device.kernels_per_env_step",
                 "contact_law_kernel_roofline", "train_mfu",
                 "rollout.collect_ms_per_step", "learn.s_per_iter"):
        assert cells.reader(name)(rec) is None
    prof = _records()
    prof["device"] = [d for d in prof["device"] if "contact" not in d[0]]
    rec.update(profile=prof, profile_steps=2)
    assert cells.reader("contact_law_kernel_roofline")(rec) is None


def test_window_readers():
    rec = {"window": {"seconds": 2.0, "iterations": 4, "steps": 96,
                      "collect_s": 1.8, "learn_s": 0.2, "flops": 6.7e12}}
    assert cells.reader("rollout.collect_ms_per_step")(rec) == \
        pytest.approx(1.8 / 96 * 1e3)
    assert cells.reader("learn.s_per_iter")(rec) == pytest.approx(0.05)
    assert cells.reader("train_mfu")(rec) == pytest.approx(5.0)


def test_breakdown_labels_gaps_by_span_and_operator():
    b = trace.breakdown(_records())
    assert b["device_ops"][0] == ["gemm", pytest.approx(40e-9)]
    gaps = dict(b["idle_gaps"])
    # a gap goes whole to what covers its middle: 0-10 and 55-60 to
    # env.step with no operator, 40-50 to aten::index, 64-70 to learn_step,
    # 76-100 (middle 88) to policy.act and the backward on thread 2
    assert gaps["env.step > python"] == pytest.approx((10 + 5) * 1e-9)
    assert gaps["env.step > aten::index"] == pytest.approx(10e-9)
    assert gaps["learn_step > python"] == pytest.approx(6e-9)
    assert gaps["policy.act > autograd::engine"] == pytest.approx(24e-9)
    assert sum(gaps.values()) == pytest.approx(55e-9)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
