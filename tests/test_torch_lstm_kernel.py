"""The LSTM unroll as a sequence op (ops/lstm_kernel.py).

On the CPU: the op's hand-written backward against finite differences
(gradcheck, float64), and the model's `unroll` (input projections and
heads once over all rows, the recurrence through the op) against the
per-step loop it replaced (kept below as `loop_unroll`, autograd through
`step`): means, values, the final carry and every parameter's gradient,
in float64 to 1e-12 and in float32 to float32 rounding of other summation
orders (relative 2e-6). Resets at step 0, in the middle and at the last
step. The GRU keeps the loop. On the card (tests marked `cuda`) the op
launches csrc/lstm.cu, held against the plain gate steps on the same
CUDA tensors, and one unroll counts T launches of each kernel.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.models.actor_critic_recurrent import ActorCriticRecurrent
from dwbc_tpu_torch.ops import kernel, lstm_kernel
from dwbc_tpu_torch.ops.lstm_kernel import (check_limits, lstm_sequence,
                                            plain_sequence)
from dwbc_tpu_torch.utils import spans


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def loop_unroll(model, carry, obs_seq, dones_seq):
    """The unroll as it ran before the sequence op: `step` per timestep."""
    means, values = [], []
    for obs, dones in zip(obs_seq, dones_seq):
        carry, mean, value = model.step(carry, obs, dones)
        means.append(mean)
        values.append(value)
    return carry, (torch.stack(means), torch.stack(values))


def resets(t_len, b):
    """dones_prev with resets at step 0, in the middle and at the last
    step, on different rows."""
    d = torch.zeros((t_len, b), dtype=torch.bool)
    d[0, 0] = d[t_len // 2, 1 % b] = d[t_len - 1, 0] = True
    return d


def inputs(m, t_len, b, h, dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, dtype=dtype)

    keep = 1.0 - resets(t_len, b).to(dtype)
    xs = (r(m, t_len, b, 4 * h), 0.5 * r(m, b, h) * keep[0][:, None],
          0.5 * r(m, b, h) * keep[0][:, None], r(m, 4 * h, h) / h ** 0.5,
          keep)
    return [x.to(device) for x in xs]


def model_and_data(rnn_type, dtype, t_len=6, b=5, hidden=8, seed=0):
    torch.manual_seed(seed)
    model = ActorCriticRecurrent(num_obs=7, num_actions=3,
                                 rnn_hidden_size=hidden, rnn_type=rnn_type,
                                 actor_hidden_dims=(16, 8),
                                 critic_hidden_dims=(8,)).to(dtype)
    g = torch.Generator().manual_seed(seed + 1)
    obs = torch.randn((t_len, b, 7), generator=g, dtype=dtype)

    def h():
        return 0.5 * torch.randn((b, hidden), generator=g, dtype=dtype)

    carry = ((h(), h()), (h(), h())) if rnn_type == "lstm" else (h(), h())
    return model, carry, obs, resets(t_len, b)


def grads_of(model, unroll, carry, obs, dones):
    """The unroll's outputs and every parameter's gradient of a loss that
    reads the means, the values and the final carry."""
    model.zero_grad(set_to_none=True)
    c, (means, values) = unroll(carry, obs, dones)
    flat = [x for pair in c for x in pair] if isinstance(c[0], tuple) \
        else list(c)
    loss = ((means ** 2).sum() + (values * means[..., :1]).sum()
            + sum((x * (k + 1)).sum() for k, x in enumerate(flat)))
    loss.backward()
    return (means.detach(), values.detach(), [x.detach() for x in flat],
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("reset", [False, True], ids=["no_resets", "resets"])
def test_hand_backward_passes_gradcheck(reset):
    xproj, c0, h0, wh, keep = inputs(2, 5, 3, 4, torch.float64)
    if not reset:
        keep = torch.ones_like(keep)
    args = [x.requires_grad_() for x in (xproj, c0, h0, wh)]
    assert torch.autograd.gradcheck(
        lambda *a: lstm_sequence(*a, keep), args, eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)],
                         ids=["float64", "float32"])
def test_unroll_matches_the_step_loop(dtype, tol):
    model, carry, obs, dones = model_and_data("lstm", dtype)
    got = grads_of(model, model.unroll, carry, obs, dones)
    want = grads_of(model, lambda *a: loop_unroll(model, *a), carry, obs,
                    dones)
    for name, g, w in (("means", got[0], want[0]), ("values", got[1],
                                                    want[1])):
        assert g.shape == w.shape
        assert rel(g, w) < tol, name
    for k, (g, w) in enumerate(zip(got[2], want[2])):
        assert rel(g, w) < tol, f"final carry {k}"
    assert got[3].keys() == want[3].keys() == dict(
        model.named_parameters()).keys() - {"std"}
    for name in want[3]:
        assert rel(got[3][name], want[3][name]) < tol, name


def test_reset_rows_forget_the_first_carry():
    """A row reset at step 0 gives what a zero carry gives."""
    model, carry, obs, dones = model_and_data("lstm", torch.float64)
    dones[0] = True
    with torch.no_grad():
        _, (m1, v1) = model.unroll(carry, obs, dones)
        _, (m0, v0) = model.unroll(model.initial_state(obs.shape[1]), obs,
                                   dones)
    torch.testing.assert_close(m1, m0, rtol=0, atol=0)
    torch.testing.assert_close(v1, v0, rtol=0, atol=0)


def test_gru_keeps_the_step_loop():
    model, carry, obs, dones = model_and_data("gru", torch.float32)
    got = grads_of(model, model.unroll, carry, obs, dones)
    want = grads_of(model, lambda *a: loop_unroll(model, *a), carry, obs,
                    dones)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(g, w)
    for name in want[3]:
        assert torch.equal(got[3][name], want[3][name]), name


def test_cpu_op_counts_no_launch():
    before = (spans.total("lstm_kernel"), spans.total("lstm_backward_kernel"))
    xproj, c0, h0, wh, keep = inputs(2, 4, 3, 5, torch.float32)
    xproj.requires_grad_()
    y, c = lstm_sequence(xproj, c0, h0, wh, keep)
    (y.sum() + c.sum()).backward()
    assert (spans.total("lstm_kernel"),
            spans.total("lstm_backward_kernel")) == before
    assert y.shape == (2, 4, 3, 5) and c.shape == (2, 3, 5)


def test_launches_pass_each_step_its_buffers_and_sizes(monkeypatch):
    """The card path on the CPU, with the device context, the stream and
    both C entries replaced by fakes that record their arguments: T
    forward launches, then T backward ones in reverse, each with the
    pointers of the plain step's arguments in its order (dh_next null at
    the last step only), then t, T, B, H, M and the stream; one launch
    counted each."""
    monkeypatch.setattr(kernel.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernel.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    calls = {"f": [], "b": []}
    monkeypatch.setattr(lstm_kernel.FORWARD, "_fn",
                        lambda *a: calls["f"].append(a) or 0)
    monkeypatch.setattr(lstm_kernel.BACKWARD, "_fn",
                        lambda *a: calls["b"].append(a) or 0)
    m, t_len, b, h = 2, 3, 4, 5
    xproj, c0, h0, wh, keep = inputs(m, t_len, b, h, torch.float32)
    xproj.requires_grad_()
    before = (spans.total("lstm_kernel"), spans.total("lstm_backward_kernel"))
    y, c = lstm_kernel._Sequence.apply(True, xproj, c0, h0, wh, keep)
    y.sum().backward()
    assert (spans.total("lstm_kernel") - before[0],
            spans.total("lstm_backward_kernel") - before[1]) == (t_len, t_len)
    sizes = (t_len, b, h, m, 7)
    assert [a[8:] for a in calls["f"]] == [(t, *sizes) for t in range(3)]
    assert [a[9:] for a in calls["b"]] == [(t, *sizes)
                                           for t in reversed(range(3))]
    f0 = calls["f"][0]
    assert (f0[0], f0[2]) == (xproj.data_ptr(), keep.data_ptr())
    # the same act, c, y, cm, hm buffers at every step
    assert len({a[3:8] for a in calls["f"]}) == 1
    assert f0[5] == y.data_ptr()
    # backward: act, c, cm as the forward wrote them, keep; dh_next null
    # at the last step only; dc_prev ping-pongs into the next dc_next
    b0, b1, b2 = calls["b"]
    assert b0[:4] == (f0[3], f0[4], f0[6], keep.data_ptr())
    assert b0[5] is None and b1[5] is not None and b2[5] is not None
    assert b1[6] == b0[8] and b2[6] == b1[8] and b0[8] != b1[8]
    assert b0[7] == b1[7] == b2[7]


def test_meta_tensor_raises():
    xproj, c0, h0, wh, keep = inputs(2, 3, 2, 4, torch.float32,
                                     device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        lstm_sequence(xproj, c0, h0, wh, keep)


@pytest.mark.parametrize("sizes", [(0, 1, 1, 1), (2, 24, 1024, 2 ** 15)])
def test_limits_refused(sizes):
    with pytest.raises(ValueError, match="lstm kernel"):
        check_limits(*sizes)


def test_limits_taken():
    check_limits(2, 24, 1024, 512)


# -- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 1024, 512), (2, 5, 33, 64),
                                   (1, 1, 7, 3)],
                         ids=["cell", "odd", "one_step"])
def test_cuda_kernels_match_the_plain_steps(card, shape):
    m, t_len, b, h = shape
    xproj, c0, h0, wh, keep = inputs(m, t_len, b, h, torch.float32,
                                     seed=b, device=card)
    outs, grads = [], []
    for op in (lstm_sequence, plain_sequence):
        args = [x.clone().requires_grad_() for x in (xproj, c0, h0, wh)]
        y, c = op(*args, keep)
        g = torch.Generator(device=card).manual_seed(1)
        dy = torch.randn(y.shape, generator=g, device=card)
        dc = torch.randn(c.shape, generator=g, device=card)
        torch.autograd.backward((y, c), (dy, dc))
        outs.append((y.detach(), c.detach()))
        grads.append([a.grad for a in args])
    torch.cuda.synchronize()
    for name, got, want in zip(("y", "c"), *outs):
        assert bool(torch.isfinite(got).all())
        assert rel(got, want) < 1e-6, name
    for name, got, want in zip(("dxproj", "dc0", "dh0", "dwh"), *grads):
        assert bool(torch.isfinite(got).all())
        assert rel(got, want) < 1e-5, name


@pytest.mark.cuda
def test_cuda_unroll_launches_each_kernel_once_a_step(card):
    t_len, b = 24, 64
    model, carry, obs, dones = model_and_data("lstm", torch.float32,
                                              t_len=t_len, b=b, hidden=32)
    model = model.to(card)
    carry = tuple(tuple(x.to(card) for x in pair) for pair in carry)
    before = (spans.total("lstm_kernel"), spans.total("lstm_backward_kernel"))
    _, (means, values) = model.unroll(carry, obs.to(card), dones.to(card))
    (means.sum() + values.sum()).backward()
    torch.cuda.synchronize()
    after = (spans.total("lstm_kernel"), spans.total("lstm_backward_kernel"))
    assert np.subtract(after, before).tolist() == [t_len, t_len]
