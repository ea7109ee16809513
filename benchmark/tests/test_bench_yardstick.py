"""The benchmark's own arithmetic: operation and byte counts, intervals,
spread."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import yardstick
from benchmark.reference.models.actor_critic import ActorCritic
from benchmark.reference.models.mlp_actor_critic import MlpActorCritic


@pytest.mark.parametrize("make", [
    lambda: MlpActorCritic(num_obs=235, num_actions=12),
    lambda: ActorCritic(num_prop=76, num_priv=24, num_hist=10),
], ids=["go1_mlp", "widowGo1_dual_head"])
def test_forward_flops_equal_flop_counter(make):
    torch.manual_seed(0)
    model = make()
    num_obs = 235 if isinstance(model, MlpActorCritic) else 860
    obs = torch.randn(7, num_obs)
    with FlopCounterMode(display=False) as fc:
        model.act_mean(obs, False)
        model.evaluate(obs)
    assert yardstick.forward_flops(model) * 7 == fc.get_total_flops()


def test_flops_per_iteration_counts_collect_and_epochs():
    model = MlpActorCritic(num_obs=235, num_actions=12)
    f = yardstick.forward_flops(model)
    assert yardstick.flops_per_iteration(model, 4096, 24, 5) == \
        f * 4096 * 24 * 16
    # the issue's count for go1 at 4096 x 24
    assert abs(yardstick.flops_per_iteration(model, 4096, 24, 5) - 1.79e12) \
        < 0.01e12


@pytest.mark.parametrize("ng,n,nbytes", [
    # 15 + 7 float32 planes, the active byte, friction, 40 B per sphere
    (84, 5000, 37_403_360), (92, 4096, 33_558_112), (92, 65536, 536_874_592),
], ids=["widowGo1-5000", "go1-4096", "go1-65536"])
def test_law_bytes_and_bound_at_the_cells_shapes(ng, n, nbytes):
    assert yardstick.law_bytes(ng, n) == nbytes
    bound, by = yardstick.law_bound_ms(ng, n)
    assert by == "bytes"
    assert bound == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    # the operations are the smaller term
    assert yardstick.LAW_FLOPS_PER_ELEM * ng * n / 67e12 * 1e3 < bound


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41), (40.5, 42)]
    assert yardstick.union_seconds(iv) == 15 + 10 + 2
    assert yardstick.union_seconds(reversed(iv)) == 27
    assert yardstick.union_seconds([]) == 0.0


def test_idle_gaps_are_the_window_less_the_union():
    iv = [(2, 4), (3, 6), (8, 9), (12, 20)]
    gaps = yardstick.idle_gaps(iv, 0, 15)
    assert gaps == [(0, 2), (6, 8), (9, 12)]
    busy = yardstick.union_seconds((max(s, 0), min(e, 15)) for s, e in iv)
    assert busy + sum(e - s for s, e in gaps) == 15
