"""`utils/measure.compare_curves` on the JAX package's committed learning
curves (logs/<family>/<run>/metrics.jsonl): every run passes the bands
its task's curve is held to, a curve made worse fails them, a resumed
run's repeated iterations count once, and a missing key is reported;
`curve_key` picks the entry of a torque-supervision weight or raises.
Plain files, no device and no JAX."""

import json
import os

import pytest

from dwbc_tpu_torch.utils import measure
from dwbc_tpu_torch.utils.measure import (CURVES, LEN, TERMS, Band,
                                          compare_curves, read_curve)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARATHON = "logs/rough_widowGo1/r5_widow_marathon/metrics.jsonl"


def runs(task):
    return [os.path.join(REPO, p) for p in CURVES[task]["runs"]]


def rows_of(path):
    with open(os.path.join(REPO, path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def compare(task, port_rows):
    return [e for checkpoints, keys in CURVES[task]["checks"]
            for e in compare_curves(port_rows, runs(task), checkpoints,
                                    keys)]


@pytest.mark.parametrize("run", CURVES["widowGo1"]["runs"])
def test_each_rough_widowgo1_run_passes_the_bands_of_all_three(run):
    out = compare("widowGo1", rows_of(run))
    assert len(out) == 5 * 4
    bad = [e for e in out if not e["ok"]]
    assert not bad, bad
    lead = {e["it"]: e["channel"] for e in out if e["key"] == TERMS}
    assert lead == {it: "Episode/term_roll" for it in (10, 20, 30, 50, 100)}


@pytest.mark.parametrize("task", ["widowGo1_flat", "go1_flat_lstm",
                                  "go1_flat", "go1", "widowGo1_adaptive",
                                  "widowGo1_adaptive@ts1"])
def test_single_run_tasks_pass_their_own_bands(task):
    (run,) = CURVES[task]["runs"]
    out = compare(task, rows_of(run))
    assert out and all(e["ok"] for e in out), out


def test_weight_one_arm_std_fails_the_weight_zero_entry():
    # the supervision gradient raises the arm's std at weight 1 and not at
    # weight 0: the weight-1 run's std is out of the weight-0 bands
    rows = rows_of(CURVES["widowGo1_adaptive@ts1"]["runs"][0])
    out = compare("widowGo1_adaptive", rows)
    arm = {e["it"]: e for e in out if e["key"] == measure.ARM_STD}
    assert sorted(arm) == [50, 100, 200]
    assert not arm[200]["ok"] and arm[200]["port"] > arm[200]["band"][1]
    # and the weight-0 run's falls below the weight-1 bands
    rows = rows_of(CURVES["widowGo1_adaptive"]["runs"][0])
    out = compare("widowGo1_adaptive@ts1", rows)
    arm = {e["it"]: e for e in out if e["key"] == measure.ARM_STD}
    assert not arm[200]["ok"] and arm[200]["port"] < arm[200]["band"][0]


@pytest.mark.parametrize("task, ts_weight, key", [
    ("widowGo1_adaptive", None, "widowGo1_adaptive"),
    ("widowGo1_adaptive", 0.0, "widowGo1_adaptive"),
    ("widowGo1_adaptive", 1.0, "widowGo1_adaptive@ts1"),
    ("go1", None, "go1")])
def test_curve_key_picks_the_entry_of_the_weight(task, ts_weight, key):
    assert measure.curve_key(task, ts_weight) == key


@pytest.mark.parametrize("task, ts_weight", [
    ("widowGo1_adaptive", 10.0), ("widowGo1_adaptive", 0.5),
    ("widowGo1", 1.0), ("a1", None)])
def test_curve_key_raises_on_an_unknown_combination(task, ts_weight):
    with pytest.raises(KeyError):
        measure.curve_key(task, ts_weight)


def test_longer_episodes_fail_at_every_checkpoint():
    rows = rows_of(CURVES["widowGo1"]["runs"][0])
    for r in rows:
        r[LEN] *= 1.5
    out = compare("widowGo1", rows)
    lens = [e for e in out if e["key"] == LEN]
    assert [e["it"] for e in lens] == [10, 20, 30, 50, 100]
    assert not any(e["ok"] for e in lens)
    # the other keys are untouched and still pass
    assert all(e["ok"] for e in out if e["key"] != LEN)


def test_band_kinds_reject_what_they_should():
    flat = rows_of(CURVES["widowGo1_flat"]["runs"][0])
    for r in flat:
        r["Episode/term_z"] = 0.9
    out = compare("widowGo1_flat", flat)
    assert [e["ok"] for e in out if e["key"] == "Episode/term_z"] == [
        False] * 3
    widow = rows_of(CURVES["widowGo1"]["runs"][1])
    for r in widow:   # pitch leads instead of roll
        r["Episode/term_pitch"], r["Episode/term_roll"] = (
            r["Episode/term_roll"], r["Episode/term_pitch"])
        r["Policy/leg_mean_noise_std"] += 0.15
        r["Train/mean_reward"] = -r["Train/mean_reward"]  # magnitude kept
    out = {(e["it"], e["key"]): e for e in compare("widowGo1", widow)}
    for it in (10, 20, 30, 50, 100):
        assert out[it, TERMS]["channel"] == "Episode/term_pitch"
        assert not out[it, TERMS]["ok"]
        assert not out[it, "Policy/leg_mean_noise_std"]["ok"]
        assert out[it, "Train/mean_reward"]["ok"]


def test_repeated_iterations_are_read_once():
    raw = rows_of(MARATHON)
    zeros = [r for r in raw if r["it"] == 0]
    assert len(zeros) == 2 and zeros[0] != zeros[1]
    curve = read_curve(os.path.join(REPO, MARATHON))
    assert len(curve) == len({r["it"] for r in raw}) < len(raw)
    assert curve[0] == zeros[0]
    # the port's rows are read the same way
    out = compare_curves(zeros[::-1], [os.path.join(REPO, MARATHON)], [0],
                         {LEN: Band("scale", 1.0, 1.0)})
    assert out[0]["port"] == zeros[1][LEN]


def test_missing_key_is_reported_not_skipped():
    rows = rows_of(CURVES["widowGo1"]["runs"][0])
    for r in rows:
        if r["it"] == 50:
            del r["Policy/leg_mean_noise_std"]
            del r["Episode/term_z"]
    rows = [r for r in rows if r["it"] != 100]
    out = compare("widowGo1", rows)
    assert len(out) == 5 * 4
    missing = {(e["it"], e["key"]) for e in out if e["missing"]}
    assert missing == {(50, "Policy/leg_mean_noise_std"), (50, TERMS)} | {
        (100, k) for k in CURVES["widowGo1"]["checks"][0][1]}
    assert not any(e["ok"] for e in out if e["missing"])
    assert all(e["missing"] == ["port"] for e in out if e["missing"])
    # a JAX run without the key is named
    out = compare_curves(rows_of(CURVES["go1_flat_lstm"]["runs"][0]),
                         runs("go1_flat_lstm"), [300],
                         {"Policy/leg_mean_noise_std": Band("offset", 0.05)})
    assert out[0]["missing"] == ["port"] + runs("go1_flat_lstm")
    assert measure.TERM_KEYS[0] == "Episode/term_roll"
