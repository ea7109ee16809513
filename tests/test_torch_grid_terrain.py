"""The port's curriculum grid terrain and its lookups against the JAX
package's, from the same configs and numpy-seeded query points.

The numpy generators are copied line for line, so heights, the min3 table
and the spawn points must be bit-equal. `sample_min3` is a gather and
must be exact; `sample` and `normal` do float32 arithmetic in both
frameworks and agree to 1e-6. Query points include ones outside the grid
and ones with negative local coordinates, where truncation toward zero
(sample_min3) and floor (sample) differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwbc_tpu.terrain import terrain as jterr
from dwbc_tpu_torch.terrain import terrain as terr

# 8 columns of equal share reach all eight subterrain families
SMALL = dict(num_rows=3, num_cols=8, border_size=5.0,
             terrain_proportions=(0.125,) * 7, seed=4)
CONFIGS = {
    "curriculum": dict(SMALL, curriculum=True),
    "random": dict(SMALL, curriculum=False),
    "default_proportions": dict(num_rows=2, num_cols=5, border_size=5.0,
                                curriculum=True, seed=9),
    "selected_stairs": dict(SMALL, selected="pyramid_stairs",
                            selected_kwargs=dict(step_w=0.31, step_h=-0.15)),
    "selected_stones": dict(SMALL, selected="stepping_stones",
                            selected_kwargs=dict(stone_size=0.8,
                                                 stone_dist=0.2,
                                                 max_height=0.05)),
}


def build(name):
    kw = CONFIGS[name]
    return (jterr.grid_terrain(jterr.GridTerrainCfg(**kw)),
            terr.grid_terrain(terr.GridTerrainCfg(**kw), device="cpu"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_is_bit_equal(name):
    jgrid, grid = build(name)
    want = np.asarray(jgrid.hf.height)
    got = grid.hf.height.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.ptp(want) > 0.05          # not a plane
    assert np.array_equal(grid.env_origins, jgrid.env_origins)
    assert grid.length == jgrid.length
    assert grid.hf.cell == jgrid.hf.cell and grid.hf.origin == jgrid.hf.origin
    assert np.array_equal(grid.hf.with_min3().min3.numpy(),
                          np.asarray(jgrid.hf.with_min3().min3))


def test_curriculum_covers_every_family():
    """Column j of the curriculum grid holds family j: no two columns of
    the test grid are alike."""
    _, grid = build("curriculum")
    h = grid.hf.height.numpy()
    n, b = 80, 50
    cols = [h[b + 2 * n:b + 3 * n, b + j * n:b + (j + 1) * n]
            for j in range(8)]
    for i in range(8):
        for j in range(i + 1, 8):
            assert not np.array_equal(cols[i], cols[j]), (i, j)


def query_points(hf, n=400, seed=0):
    rng = np.random.default_rng(seed)
    H, W = hf.height.shape
    x0, y0 = hf.origin
    x = rng.uniform(x0 - 3.0, x0 + H * hf.cell + 3.0, n)
    y = rng.uniform(y0 - 3.0, y0 + W * hf.cell + 3.0, n)
    # negative local coordinates inside one cell of the origin, and the
    # last cells
    x[:8] = x0 + np.array([-0.99, -0.5, -0.01, 0.0, 0.01, 0.5, 0.99, 1.0]) * hf.cell
    y[8:16] = y0 + np.array([-0.99, -0.5, -0.01, 0.0, 0.01, 0.5, 0.99, 1.0]) * hf.cell
    x[16:20] = x0 + (H - np.array([2.5, 2.0, 1.5, 1.0])) * hf.cell
    y[20:24] = y0 + (W - np.array([2.5, 2.0, 1.5, 1.0])) * hf.cell
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("with_table", [False, True])
def test_sample_min3_matches(with_table):
    jgrid, grid = build("curriculum")
    jhf, hf = jgrid.hf, grid.hf
    if with_table:
        jhf, hf = jhf.with_min3(), hf.with_min3()
    x, y = query_points(hf)
    want = np.asarray(jhf.sample_min3(jnp.asarray(x), jnp.asarray(y)))
    got = hf.sample_min3(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert np.array_equal(got, want)
    # a (N, P) batch, as the env's height scan passes
    got2 = hf.sample_min3(torch.as_tensor(x).reshape(20, 20),
                          torch.as_tensor(y).reshape(20, 20)).numpy()
    assert np.array_equal(got2.ravel(), want)


def test_min3_truncates_where_sample_floors():
    """At a local coordinate in (-1, 0) truncation gives cell 0 and floor
    would give -1 before the clamp: both end in cell 0 here, but one cell
    further in, at (0, 1), they must both read cell 0, and the table must
    equal the three-tap minimum."""
    _, grid = build("curriculum")
    hf = grid.hf
    h = hf.height
    x = torch.tensor([hf.origin[0] - 0.5 * hf.cell,
                      hf.origin[0] + 60.5 * hf.cell])
    y = torch.tensor([hf.origin[1] + 70.5 * hf.cell] * 2)
    want = torch.stack([torch.minimum(torch.minimum(h[0, 70], h[1, 70]),
                                      h[0, 71]),
                        torch.minimum(torch.minimum(h[60, 70], h[61, 70]),
                                      h[60, 71])])
    assert torch.equal(hf.sample_min3(x, y), want)
    assert torch.equal(hf.with_min3().sample_min3(x, y), want)


def test_sample_and_normal_match():
    jgrid, grid = build("curriculum")
    x, y = query_points(grid.hf, seed=1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(grid.hf.sample(tx, ty).numpy(),
                               np.asarray(jgrid.hf.sample(jx, jy)),
                               rtol=0, atol=1e-6)
    n = grid.hf.normal(tx, ty).numpy()
    np.testing.assert_allclose(n, np.asarray(jgrid.hf.normal(jx, jy)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-6)
    assert (np.abs(n[:, :2]).max(-1) > 0.1).mean() > 0.1   # slopes are hit
