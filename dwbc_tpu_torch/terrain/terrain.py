"""Terrain generation + heightfield queries on torch tensors.

Counterpart of dwbc_tpu/terrain/terrain.py (the rollout's subset:
`Heightfield` sampling, `flat_plane`, fractal Perlin). Generation runs
once at startup in numpy / native C++; the heightfield then lives on the
device as a float32 tensor with O(1) bilinear lookups.

The grid lookups clamp their indices exactly as the reference does
(terrain.py:56-57, 101-102): JAX clamps out-of-range gathers silently,
torch raises on the CPU and device-asserts on CUDA, so the clamps are
what keeps every gather in range.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import native
from ..utils.device import resolve_device


class Heightfield(NamedTuple):
    """Device-side terrain: world (x, y) maps to grid (ix, iy) via
    ix = (x - origin_x) / cell."""

    height: torch.Tensor        # (H, W) float32 meters; axis 0 = x, axis 1 = y
    cell: float
    origin: Tuple[float, float]  # world coords of grid index (0, 0)

    def _corners(self, x, y):
        H, W = self.height.shape
        gx = (x - self.origin[0]) / self.cell
        gy = (y - self.origin[1]) / self.cell
        gx = torch.clamp(gx, 0.0, H - 1.001)
        gy = torch.clamp(gy, 0.0, W - 1.001)
        ix = torch.floor(gx).long()
        iy = torch.floor(gy).long()
        fx = gx - ix
        fy = gy - iy
        h = self.height
        return (fx, fy, h[ix, iy], h[ix + 1, iy], h[ix, iy + 1],
                h[ix + 1, iy + 1])

    def sample(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Bilinear height lookup; clamps at borders."""
        fx, fy, h00, h10, h01, h11 = self._corners(x, y)
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    def sample_with_normal(self, x: torch.Tensor, y: torch.Tensor):
        """(height, normal) from one 2x2 corner fetch: bilinear height plus
        the cell's finite-difference normal, as a 3-tuple of components."""
        fx, fy, h00, h10, h01, h11 = self._corners(x, y)
        h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
             + h01 * (1 - fx) * fy + h11 * fx * fy)
        dhdx = ((h10 + h11) - (h00 + h01)) / (2 * self.cell)
        dhdy = ((h01 + h11) - (h00 + h10)) / (2 * self.cell)
        inv = torch.rsqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
        return h, (-dhdx * inv, -dhdy * inv, inv)


def heightfield_from_numpy(height: np.ndarray, cell: float, origin,
                           device="cuda") -> Heightfield:
    """Heightfield on `device` from a numpy height array (cast to f32)."""
    dev = resolve_device(device)
    return Heightfield(
        height=torch.as_tensor(np.asarray(height, np.float32), device=dev),
        cell=float(cell), origin=(float(origin[0]), float(origin[1])))


def flat_plane(size: float = 100.0, cell: float = 1.0,
               device="cuda") -> Heightfield:
    dev = resolve_device(device)
    n = int(2 * size / cell) + 1
    return Heightfield(height=torch.zeros((n, n), device=dev), cell=cell,
                       origin=(-size, -size))


# ---------------------------------------------------------------------------
# fractal Perlin (numpy, init time)


def _perlin_2d(rng: np.random.Generator, shape, res):
    def fade(t):
        return 6 * t**5 - 15 * t**4 + 10 * t**3

    delta = (res[0] / shape[0], res[1] / shape[1])
    d = (shape[0] // res[0], shape[1] // res[1])
    grid = np.mgrid[0:res[0]:delta[0], 0:res[1]:delta[1]].transpose(1, 2, 0) % 1
    angles = 2 * np.pi * rng.random((res[0] + 1, res[1] + 1))
    gradients = np.dstack((np.cos(angles), np.sin(angles)))
    g00 = gradients[:-1, :-1].repeat(d[0], 0).repeat(d[1], 1)
    g10 = gradients[1:, :-1].repeat(d[0], 0).repeat(d[1], 1)
    g01 = gradients[:-1, 1:].repeat(d[0], 0).repeat(d[1], 1)
    g11 = gradients[1:, 1:].repeat(d[0], 0).repeat(d[1], 1)
    n00 = np.sum(grid * g00, 2)
    n10 = np.sum(np.dstack((grid[..., 0] - 1, grid[..., 1])) * g10, 2)
    n01 = np.sum(np.dstack((grid[..., 0], grid[..., 1] - 1)) * g01, 2)
    n11 = np.sum(np.dstack((grid[..., 0] - 1, grid[..., 1] - 1)) * g11, 2)
    t = fade(grid)
    n0 = n00 * (1 - t[..., 0]) + t[..., 0] * n10
    n1 = n01 * (1 - t[..., 0]) + t[..., 0] * n11
    return np.sqrt(2) * ((1 - t[..., 1]) * n0 + t[..., 1] * n1) * 0.5 + 0.5


def fractal_noise(rng: np.random.Generator, x_size: int, y_size: int,
                  x_samples: int, y_samples: int, z_scale: float,
                  frequency: int = 10, octaves: int = 2,
                  lacunarity: float = 2.0, gain: float = 0.25) -> np.ndarray:
    x_scale = frequency * x_size
    y_scale = frequency * y_size
    amplitude = 1.0
    noise = np.zeros((x_samples, y_samples))
    for _ in range(octaves):
        noise += amplitude * _perlin_2d(rng, (x_samples, y_samples),
                                        (x_scale, y_scale)) * z_scale
        amplitude *= gain
        x_scale, y_scale = int(lacunarity * x_scale), int(lacunarity * y_scale)
    return noise


@dataclasses.dataclass
class PerlinTerrainCfg:
    """Leaf values of the reference widowGo1 terrain cfg
    (widowGo1_config.py:289-315)."""

    horizontal_scale: float = 0.025
    tot_cols: int = 600    # x extent in cells
    tot_rows: int = 10000  # y extent in cells
    z_scale: float = 0.15
    wall_height: float = 100000.0
    # int16 height quantization step (reference terrain.py:51)
    vertical_scale: float = 0.005
    seed: int = 0


def perlin_heights(cfg: PerlinTerrainCfg) -> np.ndarray:
    """The (tot_cols, tot_rows) float32 height array of `perlin_terrain`."""
    x_size = int(cfg.horizontal_scale * cfg.tot_cols)
    y_size = int(cfg.horizontal_scale * cfg.tot_rows)
    frequency = 10
    # native C++ generator when it builds; numpy fallback. Same algorithm,
    # different RNG stream — both deterministic per seed.
    h = native.fractal_noise(cfg.tot_cols, cfg.tot_rows,
                             frequency * x_size, frequency * y_size,
                             cfg.z_scale, seed=cfg.seed)
    if h is None:
        h = fractal_noise(np.random.default_rng(cfg.seed), x_size, y_size,
                          cfg.tot_cols, cfg.tot_rows, z_scale=cfg.z_scale,
                          frequency=frequency)
    else:
        h = h.astype(np.float64)
    # wall fencing trick (reference terrain.py:49)
    h[cfg.tot_cols // 2 - 100:, :] += cfg.wall_height
    # int16 quantization parity (reference terrain.py:51)
    if cfg.vertical_scale > 0:
        h = np.round(h / cfg.vertical_scale) * cfg.vertical_scale
    return h.astype(np.float32)


def perlin_terrain(cfg: PerlinTerrainCfg, device="cuda") -> Heightfield:
    dev = resolve_device(device)
    # centre the mesh like the reference trimesh transform
    # (widowGo1_config.py:299-301)
    origin = (-cfg.tot_cols * cfg.horizontal_scale / 2,
              -cfg.tot_rows * cfg.horizontal_scale / 2)
    return heightfield_from_numpy(perlin_heights(cfg), cfg.horizontal_scale,
                                  origin, dev)
