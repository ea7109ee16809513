"""The recurrent policy's LSTM unroll as one sequence op, with its gates as
hand-written CUDA kernels for Hopper.

`lstm_sequence(xproj, c0, h0, wh, keep)` runs the recurrence of M LSTM
memories over T steps of B rows at once, as a `torch.autograd.Function`
with a hand-written backward. Its inputs are what does not depend on the
carry: `xproj` (M, T, B, 4H), each step's input projection with the
hidden side's bias; the first carry `c0`, `h0` (M, B, H), already masked
by keep[0]; the stacked recurrent kernels `wh` (M, 4H, H); `keep` (T, B),
1 - dones_prev. It returns `y` (M, T, B, H), every step's h, and the final
c (M, B, H); the final h is y[:, -1]. Between steps the carry is
multiplied by keep[t + 1], as each eager step masked it.

Each step forward is one batched product h_masked W_h^T for all M
memories and one gate step (`forward_step`); each step backward one gate
step (`backward_step`) and one product dgates W_h. After the loop the
recurrent kernels' gradient is one product over all T x B rows. The device
rule is ops/kernel.py's: on CPU tensors the gate steps run their plain
PyTorch versions below, on CUDA tensors they launch csrc/lstm.cu (the
launch counters `lstm_kernel` forward and `lstm_backward_kernel`), on any
other device the op raises ValueError. The checks run once a sequence,
not once a step. The kernel takes float32 and indexes its arrays with
32-bit offsets (`check_limits`).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel

# both entries live in one library, built once with these flags
FLAGS = ("-fmad=false",)
FORWARD = kernel.Kernel("lstm_kernel", "lstm.cu", "dwbc_lstm_forward",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5,
                        flags=FLAGS)
BACKWARD = kernel.Kernel("lstm_backward_kernel", "lstm.cu",
                         "dwbc_lstm_backward",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5,
                         flags=FLAGS)
build = FORWARD.build


def check_limits(m: int, t: int, b: int, h: int) -> None:
    """Raise ValueError unless every size is at least 1 and the (M, T, B,
    4H) gate arrays fit 32-bit offsets."""
    if min(m, t, b, h) < 1 or 4 * m * t * b * h >= 2 ** 32:
        raise ValueError(f"lstm kernel: {m} memories x {t} steps x {b} rows "
                         f"x {h} units, needs each >= 1 and 4 x their "
                         f"product < 2^32")


def forward_step(t, xproj, hh, keep, act, c, y, cm, hm):
    """Step t of the forward pass, the plain version of the kernel
    `lstm_kernel`: the gates from xproj[:, t] + hh, c and h of step t into
    act, c and y at t, and the carry of step t + 1, masked by keep[t + 1],
    into cm and hm at t + 1 (but at the last step)."""
    i, f, g, o = (xproj[:, t] + hh).chunk(4, -1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    ct = f * cm[:, t] + i * g
    ht = o * torch.tanh(ct)
    act[:, t] = torch.cat([i, f, g, o], -1)
    c[:, t] = ct
    y[:, t] = ht
    if t + 1 < keep.shape[0]:
        k = keep[t + 1][:, None]
        cm[:, t + 1] = ct * k
        hm[:, t + 1] = ht * k


def backward_step(t, act, c, cm, keep, dy, dh_next, dc_next, dxp, dc_prev):
    """Step t of the backward pass, the plain version of the kernel
    `lstm_backward_kernel`: from the gradients of y at t and of step t +
    1's carry (dh_next is None at the last step, where dc_next is the
    final c's), the pre-activations' gradients into dxp at t and the
    gradient of step t's carry c into dc_prev."""
    i, f, g, o = act[:, t].chunk(4, -1)
    dh, dc = dy[:, t], dc_next
    if dh_next is not None:
        k = keep[t + 1][:, None]
        dh = dh + dh_next * k
        dc = dc * k
    tc = torch.tanh(c[:, t])
    d_o = dh * tc
    dc = (dh * o) * (1.0 - tc * tc) + dc
    d_i, d_f, d_g = dc * g, dc * cm[:, t], dc * i
    dxp[:, t] = torch.cat([d_i * (1.0 - i) * i, d_f * (1.0 - f) * f,
                           d_g * (1.0 - g * g), d_o * (1.0 - o) * o], -1)
    dc_prev.copy_(dc * f)


def steps(on_card, size):
    """The gate steps: the kernels' launches on the card, the plain
    versions on the CPU. Each takes its plain version's arguments; the
    launches pass the tensors' pointers and `size` (T, B, H, M)."""
    if not on_card:
        return forward_step, backward_step

    def ptr(x):
        return None if x is None else x.data_ptr()

    def fwd(t, *args):
        FORWARD.launch(args[0].device, *map(ptr, args), t, *size)

    def bwd(t, *args):
        BACKWARD.launch(args[0].device, *map(ptr, args), t, *size)

    return fwd, bwd


class _Sequence(torch.autograd.Function):
    """lstm_sequence's autograd: the forward loop above, and the backward
    in reverse over the steps (the module docstring)."""

    @staticmethod
    def forward(ctx, on_card, xproj, c0, h0, wh, keep):
        m, t_len, b, h4 = xproj.shape
        h = h4 // 4
        fwd, _ = steps(on_card, (t_len, b, h, m))
        act = torch.empty_like(xproj)
        c, y, cm, hm = (xproj.new_empty((m, t_len, b, h)) for _ in range(4))
        cm[:, 0] = c0
        hm[:, 0] = h0
        wht = wh.transpose(1, 2)
        for t, hm_t in enumerate(hm.unbind(1)):
            fwd(t, xproj, torch.bmm(hm_t, wht), keep, act, c, y, cm, hm)
        ctx.on_card = on_card
        ctx.save_for_backward(wh, keep, act, c, cm, hm)
        return y, c[:, -1].clone()

    @staticmethod
    def backward(ctx, dy, dc_last):
        wh, keep, act, c, cm, hm = ctx.saved_tensors
        m, t_len, b, h = c.shape
        _, bwd = steps(ctx.on_card, (t_len, b, h, m))
        dy, dc_next = dy.contiguous(), dc_last.contiguous()
        dxp = torch.empty_like(act)
        dc_bufs = (torch.empty_like(dc_next), torch.empty_like(dc_next))
        dh_next = None
        for t in reversed(range(t_len)):
            dc_prev = dc_bufs[t % 2]
            bwd(t, act, c, cm, keep, dy, dh_next, dc_next, dxp, dc_prev)
            # the gradient of step t's carry h, needed before step 0 only
            # where h0 needs one
            dh_next = (torch.bmm(dxp[:, t], wh)
                       if t or ctx.needs_input_grad[3] else None)
            dc_next = dc_prev
        dwh = torch.bmm(dxp.view(m, t_len * b, 4 * h).transpose(1, 2),
                        hm.view(m, t_len * b, h))
        return None, dxp, dc_next, dh_next, dwh, None


def lstm_sequence(xproj, c0, h0, wh, keep):
    """The recurrence of the module docstring, under the device rule:
    returns (y (M, T, B, H), final c (M, B, H))."""
    on_card = FORWARD.takes(xproj)
    if on_card:
        m, t_len, b, h4 = xproj.shape
        h = h4 // 4
        check_limits(m, t_len, b, h)
        dev = xproj.device
        for name, x, shape in (("xproj", xproj, (m, t_len, b, 4 * h)),
                               ("c0", c0, (m, b, h)), ("h0", h0, (m, b, h)),
                               ("wh", wh, (m, 4 * h, h)),
                               ("keep", keep, (t_len, b))):
            kernel.check(name, x, shape, dev)
            if not x.is_contiguous():
                raise ValueError(f"{name}: not contiguous")
    return _Sequence.apply(on_card, xproj, c0, h0, wh, keep)


def plain_sequence(xproj, c0, h0, wh, keep):
    """lstm_sequence with the plain gate steps on any device: what the
    card tests and chip_smoke.py hold the kernels against."""
    return _Sequence.apply(False, xproj, c0, h0, wh, keep)
