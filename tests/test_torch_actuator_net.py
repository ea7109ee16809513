"""The port's ANYdrive actuator net against the JAX package's: the same
vendored weights, the same numpy-seeded inputs, four chained steps (one
policy step's substeps). Torques and hidden state within 1e-6."""

import jax.numpy as jnp
import numpy as np
import torch

from dwbc_tpu.models import actuator_net as jnet
from dwbc_tpu_torch.models import actuator_net as net


def test_params_are_the_vendored_weights():
    jp, p = jnet.load_params(), net.load_params(device="cpu")
    for name in ("w_ih", "w_hh", "b"):
        for a, b in zip(getattr(p, name), getattr(jp, name)):
            assert a.dtype == torch.float32
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(p.w_out.numpy(), np.asarray(jp.w_out))
    assert np.array_equal(p.b_out.numpy(), np.asarray(jp.b_out))
    assert p.w_ih[0].shape == (32, 2) and p.w_hh[1].shape == (32, 8)


def test_init_hidden():
    h = net.init_hidden(24, device="cpu")
    assert h.shape == (2, 2, 24, 8) and not h.any()
    assert h.shape == jnet.init_hidden(24).shape


def test_four_chained_steps_match():
    jp, p = jnet.load_params(), net.load_params(device="cpu")
    rng = np.random.default_rng(0)
    B = 16 * 12
    hidden = (0.5 * rng.normal(size=(2, 2, B, 8))).astype(np.float32)
    jh, h = jnp.asarray(hidden), torch.as_tensor(hidden)
    seen = []
    for _ in range(4):
        x = np.stack([0.3 * rng.normal(size=B), 4.0 * rng.normal(size=B)],
                     -1).astype(np.float32)
        jtau, jh = jnet.step(jp, jnp.asarray(x), jh)
        tau, h = net.step(p, torch.as_tensor(x), h)
        assert tau.shape == (B,) and h.shape == (2, 2, B, 8)
        np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-6)
        seen.append(tau.numpy())
    # the state matters: the four torques differ beyond the tolerance
    assert np.abs(seen[0] - seen[3]).max() > 1e-2
    assert np.abs(np.concatenate(seen)).max() > 1.0   # newton metres
