"""The port's terrain against the JAX package's: the same Perlin heights
bit for bit from the same seed (native C++ generator and numpy
generator), heightfield lookups at 1e-6, points outside the grid
included, and the trimesh export (native, numpy and the JAX package's:
triangles exact, vertices 1e-6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dwbc_tpu import native as jnative
from dwbc_tpu.terrain import terrain as jterr
from dwbc_tpu_torch import native
from dwbc_tpu_torch.terrain import terrain as terr

SMALL = dict(horizontal_scale=0.025, tot_cols=240, tot_rows=400, z_scale=0.15)


@pytest.mark.parametrize("seed", [0, 7])
def test_perlin_heights_bit_equal(seed, monkeypatch):
    ref = jterr.perlin_terrain(jterr.PerlinTerrainCfg(seed=seed, **SMALL))
    assert native.fractal_noise(4, 4, 2, 2, 1.0) is not None
    if not jnative.available():
        # the JAX package fell back to its numpy generator (its native
        # library failed to build or load): compare like with like
        monkeypatch.setattr(native, "fractal_noise", lambda *a, **k: None)
    hf = terr.perlin_terrain(terr.PerlinTerrainCfg(seed=seed, **SMALL),
                             device="cpu")
    np.testing.assert_array_equal(hf.height.numpy(), np.asarray(ref.height))
    assert hf.cell == ref.cell
    np.testing.assert_allclose(hf.origin, ref.origin, rtol=0, atol=0)


def test_numpy_fractal_noise_bit_equal():
    args = (6, 10, 240, 400, 0.15)
    ref = jterr.fractal_noise(np.random.default_rng(3), *args)
    out = terr.fractal_noise(np.random.default_rng(3), *args)
    np.testing.assert_array_equal(out, ref)


def _points(rng, hf, n):
    """Points over the grid and up to 2 m beyond each border."""
    H, W = hf.height.shape
    x = rng.uniform(hf.origin[0] - 2.0, hf.origin[0] + H * hf.cell + 2.0, n)
    y = rng.uniform(hf.origin[1] - 2.0, hf.origin[1] + W * hf.cell + 2.0, n)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("method", ["sample", "sample_with_normal"])
def test_heightfield_lookups_match(method):
    h = terr.perlin_heights(terr.PerlinTerrainCfg(seed=1, **SMALL))
    origin = (-3.0, -5.0)
    jhf = jterr.Heightfield(height=jnp.asarray(h), cell=0.025, origin=origin)
    hf = terr.heightfield_from_numpy(h, 0.025, origin, "cpu")
    x, y = _points(np.random.default_rng(0), hf, 4096)
    outside = ((x < origin[0]) | (x > origin[0] + 240 * 0.025)
               | (y < origin[1]) | (y > origin[1] + 400 * 0.025))
    assert outside.sum() > 100
    ref = getattr(jhf, method)(jnp.asarray(x), jnp.asarray(y))
    out = getattr(hf, method)(torch.as_tensor(x), torch.as_tensor(y))
    if method == "sample":
        ref, out = (ref,), (out,)
    else:
        ref, out = (ref[0], *ref[1]), (out[0], *out[1])
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("method, min3", [
    ("sample", False), ("sample_with_normal", False), ("sample_min3", False),
    ("sample_min3", True)])
def test_heightfield_lookups_at_non_finite_coordinates(method, min3):
    """Every pair of NaN, +-inf, +-1e20, 3e9 and ordinary coordinates
    inside and outside the grid: the port returns the JAX package's
    values, NaN exactly where JAX gives NaN, and nothing raises (a NaN
    used to reach the gather as int64's minimum). For sample_min3 the
    cell indices are equal as well: heights that name their cell tell
    them apart."""
    rng = np.random.default_rng(4)
    H, W = 10, 12
    h = rng.normal(size=(H, W)).astype(np.float32)
    if method == "sample_min3":
        # heights falling along both axes: the min of a cell's three taps
        # is h[i + 1, j], unique to the cell, so the value names the index
        h = np.arange(H * W, dtype=np.float32).reshape(H, W)[::-1, ::-1].copy()
    origin = (-1.0, -2.0)
    jhf = jterr.Heightfield(height=jnp.asarray(h), cell=0.1, origin=origin)
    hf = terr.heightfield_from_numpy(h, 0.1, origin, "cpu")
    if min3:
        jhf, hf = jhf.with_min3(), hf.with_min3()
    vals = np.array([np.nan, np.inf, -np.inf, 1e20, -1e20, 3e9, 0.35, -0.45,
                     -5.0, 100.0], np.float32)
    x, y = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    ref = getattr(jhf, method)(jnp.asarray(x), jnp.asarray(y))
    out = getattr(hf, method)(torch.as_tensor(x), torch.as_tensor(y))
    if method == "sample_with_normal":
        ref, out = (ref[0], *ref[1]), (out[0], *out[1])
    else:
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isnan(o.numpy()), np.isnan(r))
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-6, atol=1e-6)
    nan_in = np.isnan(x) | np.isnan(y)
    if method == "sample_min3":
        assert not np.isnan(ref[0]).any()
    else:
        np.testing.assert_array_equal(np.isnan(np.asarray(ref[0])), nan_in)


def _stairs(seed):
    """A small heightfield with steps (walls for the slope correction)
    and noise."""
    rng = np.random.default_rng(seed)
    h = np.floor(np.arange(9)[:, None] / 3.0) * 0.12 + np.zeros((9, 7))
    return (h + 0.005 * rng.normal(size=h.shape)).astype(np.float32)


def test_trimesh_native_matches_numpy(monkeypatch):
    h = np.arange(20, dtype=np.float32).reshape(4, 5) * 0.01
    assert native.available()
    vn, tn = native.heightfield_to_trimesh(h, 0.1, (-1.0, 2.0))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert not native.available()
    vf, tf = native.heightfield_to_trimesh(h, 0.1, (-1.0, 2.0))
    np.testing.assert_allclose(vn, vf, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tn, tf)
    assert tn.dtype == tf.dtype == np.int32


@pytest.mark.parametrize("slope_threshold", [None, 0.75])
def test_trimesh_matches_jax(slope_threshold):
    h = _stairs(3)
    ref_v, ref_t = jterr.heightfield_to_trimesh(
        jterr.Heightfield(height=jnp.asarray(h), cell=0.1, origin=(-0.4, 0.3)),
        slope_threshold)
    v, t = terr.heightfield_to_trimesh(
        terr.heightfield_from_numpy(h, 0.1, (-0.4, 0.3), "cpu"),
        slope_threshold)
    assert t.dtype == ref_t.dtype and v.dtype == ref_v.dtype
    np.testing.assert_array_equal(t, ref_t)
    np.testing.assert_allclose(v, ref_v, rtol=0, atol=1e-6)
    if slope_threshold is not None:   # the correction moved some vertices
        flat_v, _ = terr.heightfield_to_trimesh(
            terr.heightfield_from_numpy(h, 0.1, (-0.4, 0.3), "cpu"))
        assert not np.allclose(v[:, :2], flat_v[:, :2])
