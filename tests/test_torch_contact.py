"""The port's contact law against the JAX package's, and its CUDA kernel
against the plain version (on the card only).

Inputs are a numpy version of the Pallas parity scene
(tests/test_contact_pallas.py:_random_scene): positions straddling the
surface so about half the spheres are active, random tangent planes,
warm-start carries, per-env friction, and random per-geom constants.
Tolerances are the Pallas parity test's: gF and cf_new rtol 1e-5 /
atol 5e-5, `active` exact, share_f rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.ops.contact_kernel import check_limits, contact_law
from dwbc_tpu_torch.sim.contact import ContactParams, GeomConst, fused_terrain_law
from dwbc_tpu_torch.utils import spans

DT = 0.005


def random_scene(n, ng=13, nb=5, seed=0, sorted=True):
    """numpy arrays: gp, gv, fprev, nrm (3, ng, n); h, ax, ay (ng, n);
    friction (n,); per-geom radius, m_solo, m_body (ng,), w6 (6, ng),
    geom_body (ng,) int32, sorted by body or in random order."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gp = (rng.normal(size=(3, ng, n)) * 0.3).astype(f32)
    gv = rng.normal(size=(3, ng, n)).astype(f32)
    fprev = (np.abs(rng.normal(size=(3, ng, n))) * 5.0).astype(f32)
    nx = (0.3 * rng.normal(size=(ng, n))).astype(f32)
    ny = (0.3 * rng.normal(size=(ng, n))).astype(f32)
    inv = (1.0 / np.sqrt(nx * nx + ny * ny + 1.0)).astype(f32)
    nrm = np.stack([nx * inv, ny * inv, inv]).astype(f32)
    h = (0.1 * rng.normal(size=(ng, n))).astype(f32)
    ax = (gp[0] - 0.01).astype(f32)
    ay = (gp[1] + 0.02).astype(f32)
    friction = np.linspace(0.4, 2.5, n).astype(f32)
    body = rng.integers(0, nb, ng).astype(np.int32)
    if sorted:
        body = np.sort(body)
    m_solo = rng.uniform(0.3, 2.0, ng).astype(f32)
    w = np.zeros((ng, 3, 3), f32)
    for g in range(ng):
        a = rng.normal(size=(3, 3)).astype(f32) * 0.3
        w[g] = a @ a.T + np.eye(3) / m_solo[g]
    w6 = np.stack([w[:, i, j] for i, j in
                   ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]).astype(f32)
    return dict(gp=gp, gv=gv, fprev=fprev, nrm=nrm, h=h, ax=ax, ay=ay,
                friction=friction, radius=rng.uniform(0.01, 0.05, ng).astype(f32),
                m_solo=m_solo, m_body=rng.uniform(1.0, 8.0, ng).astype(f32),
                w6=w6, geom_body=body, nb=nb)


def jax_law(s):
    # JAX is imported here, not with the file: the card's machine has none,
    # and this file's card tests run there
    import jax.numpy as jnp
    from dwbc_tpu.sim import contact as jcontact

    E = np.zeros((s["nb"], len(s["geom_body"])), np.float32)
    E[s["geom_body"], np.arange(len(s["geom_body"]))] = 1.0
    col = lambda a: jnp.asarray(a)[:, None]
    gc = dict(radius=col(s["radius"]), m_solo=col(s["m_solo"]),
              m_body=col(s["m_body"]),
              W={k: col(s["w6"][i]) for i, k in
                 enumerate(("xx", "yy", "zz", "xy", "xz", "yz"))},
              E=jnp.asarray(E))
    t3 = lambda a: tuple(jnp.asarray(a[k]) for k in range(3))
    cache = (jnp.asarray(s["h"]), t3(s["nrm"]), jnp.asarray(s["ax"]),
             jnp.asarray(s["ay"]))
    gF, cf, active, share_f = jcontact.fused_terrain_law(
        t3(s["gp"]), t3(s["gv"]), cache, t3(s["fprev"]),
        jnp.asarray(s["friction"]), gc, ContactParams(dt=DT), DT)
    return (np.stack([np.asarray(x) for x in gF]),
            np.stack([np.asarray(x) for x in cf]), np.asarray(active),
            np.asarray(share_f))


def torch_args(s, device):
    t = lambda a: torch.as_tensor(a, device=device)
    gc = GeomConst(radius=t(s["radius"]), m_solo=t(s["m_solo"]),
                   m_body=t(s["m_body"]), w6=t(s["w6"]),
                   geom_body=t(s["geom_body"]), nb=s["nb"])
    return (t(s["gp"]), t(s["gv"]), (t(s["h"]), t(s["nrm"]), t(s["ax"]),
                                      t(s["ay"])),
            t(s["fprev"]), t(s["friction"]), gc, ContactParams(dt=DT), DT)


def assert_law_close(out, ref):
    gF, cf, active, share_f = (x.cpu().numpy() if torch.is_tensor(x) else x
                               for x in out)
    np.testing.assert_allclose(gF, ref[0], rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(cf, ref[1], rtol=1e-5, atol=5e-5)
    np.testing.assert_array_equal(active, ref[2])
    np.testing.assert_allclose(share_f, ref[3], rtol=1e-6)


@pytest.mark.parametrize("n, ng, nb, sorted", [
    pytest.param(256, 13, 5, True, id="256"),
    pytest.param(2048 + 256, 13, 5, True, id="2304"),
    # the kernel's limits, and one env; geom->body maps in random order
    pytest.param(97, 128, 32, False, id="128x32x97-unsorted"),
    pytest.param(1, 84, 21, False, id="84x21x1-unsorted"),
    # the legged robots' sphere counts on 13 bodies
    pytest.param(64, 92, 13, True, id="go1-92x13"),
    pytest.param(64, 22, 13, True, id="anymal_c-22x13"),
    pytest.param(64, 5, 13, True, id="cassie-5x13"),
])
def test_plain_law_matches_jax_law(n, ng, nb, sorted):
    s = random_scene(n, ng, nb, sorted=sorted)
    if not sorted:
        assert np.any(np.diff(s["geom_body"]) < 0)
    ref = jax_law(s)
    assert 0.05 < ref[2].mean() < 0.95  # both branches exercised
    launches = spans.total("contact_kernel")
    # on CPU tensors the op IS the plain version, and launches nothing
    assert_law_close(contact_law(*torch_args(s, "cpu")), ref)
    assert spans.total("contact_kernel") == launches
    assert_law_close(fused_terrain_law(*torch_args(s, "cpu")), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n, ng, nb, sorted", [
    pytest.param(8192, 84, 21, True, id="8192"),
    pytest.param(1024, 84, 21, True, id="1024"),
    pytest.param(8192 + 77, 84, 21, True, id="8269"),
    pytest.param(1, 13, 5, True, id="13x5x1"),
    pytest.param(33, 128, 32, True, id="128x32x33"),
    pytest.param(8192, 84, 21, False, id="8192-unsorted"),
    # the legged robots: go1, a1, anymal_b, anymal_c, cassie
    pytest.param(4096, 92, 13, True, id="go1-92x13x4096"),
    pytest.param(4096, 76, 13, True, id="a1-76x13x4096"),
    pytest.param(4096, 28, 13, True, id="anymal_b-28x13x4096"),
    pytest.param(4096, 22, 13, True, id="anymal_c-22x13x4096"),
    pytest.param(4096, 5, 13, True, id="cassie-5x13x4096"),
    # play's 5 envs, and one of two ranks' share of go1's 4096 envs
    pytest.param(5, 92, 13, True, id="go1-play-92x13x5"),
    pytest.param(5, 84, 21, True, id="widowGo1-play-84x21x5"),
    pytest.param(2048, 92, 13, True, id="go1-rank-92x13x2048"),
])
def test_cuda_kernel_matches_plain_law(n, ng, nb, sorted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = random_scene(n, ng, nb, sorted=sorted)
    args = torch_args(s, "cuda")
    plain = [x.cpu().numpy() for x in fused_terrain_law(*args)]
    launches = spans.total("contact_kernel")
    out = contact_law(*args)
    torch.cuda.synchronize()
    assert spans.total("contact_kernel") == launches + 1
    assert_law_close(out, plain)


def test_kernel_wrapper_rejects_unsupported_device():
    s = random_scene(16)
    args = list(torch_args(s, "cpu"))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        contact_law(*args)


@pytest.mark.parametrize("ng, nb, n", [(129, 21, 8192), (84, 33, 8192),
                                      (128, 32, 2 ** 32 // 384 + 1)])
def test_kernel_limits_raise_before_launch(ng, nb, n):
    check_limits(128, 32, 2 ** 32 // 384)
    with pytest.raises(ValueError):
        check_limits(ng, nb, n)
