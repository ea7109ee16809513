"""Terrain generation + heightfield queries on torch tensors.

Counterpart of dwbc_tpu/terrain/terrain.py: `Heightfield` sampling,
`flat_plane`, fractal Perlin and the curriculum grid (rows = difficulty,
cols = type, seven subterrain kinds). Generation runs once at startup in
numpy / native C++ (the numpy generators are the JAX package's line for
line, so that one seed gives bit-equal heights); the heightfield then
lives on the device as a float32 tensor with O(1) bilinear lookups.
`heightfield_to_trimesh` exports a heightfield as a triangle mesh (numpy,
host side).

The grid lookups clamp their indices exactly as the reference does
(terrain.py:56-57, 101-102): JAX clamps out-of-range gathers silently,
torch raises on the CPU and device-asserts on CUDA, so the clamps are
what keeps every gather in range.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..utils.device import resolve_device


def _saturating_index(g: torch.Tensor, size: int) -> torch.Tensor:
    """Grid coordinate g truncated toward zero to an integer index the way
    XLA's saturating float-to-int cast gives it after the same clamp to
    [0, size - 2]: NaN to 0, +inf and values past int64's range to the
    top, -inf to the bottom (a plain `.long()` gives int64's minimum for
    all of them)."""
    return torch.clamp(torch.nan_to_num(g, nan=0.0), -1.0, size - 1.0).long()


class Heightfield(NamedTuple):
    """Device-side terrain: world (x, y) maps to grid (ix, iy) via
    ix = (x - origin_x) / cell."""

    height: torch.Tensor        # (H, W) float32 meters; axis 0 = x, axis 1 = y
    cell: float
    origin: Tuple[float, float]  # world coords of grid index (0, 0)
    # optional precomputed 3-tap min table: min3[i, j] = min(h[i, j],
    # h[i+1, j], h[i, j+1]). sample_min3 is a pure function of the cell
    # index, so the min folds into one gather instead of three, with
    # bit-identical results.
    min3: Optional[torch.Tensor] = None

    def with_min3(self) -> "Heightfield":
        h = self.height
        h_r = torch.cat([h[1:], h[-1:]], 0)
        h_c = torch.cat([h[:, 1:], h[:, -1:]], 1)
        return self._replace(min3=torch.minimum(torch.minimum(h, h_r), h_c))

    def _corners(self, x, y):
        H, W = self.height.shape
        gx = (x - self.origin[0]) / self.cell
        gy = (y - self.origin[1]) / self.cell
        gx = torch.clamp(gx, 0.0, H - 1.001)
        gy = torch.clamp(gy, 0.0, W - 1.001)
        # a NaN coordinate passes the clamp: index cell 0 with it (as
        # XLA's cast does) and keep it in fx, so its height is NaN
        ix = torch.floor(torch.nan_to_num(gx, nan=0.0)).long()
        iy = torch.floor(torch.nan_to_num(gy, nan=0.0)).long()
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

    def sample_min3(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The reference's conservative 3-tap min lookup used for measured
        heights (legged_robot.py:820-829). The cell index is the grid
        coordinate truncated toward zero, then clamped (`sample` floors
        after its clamp)."""
        H, W = self.height.shape
        ix = torch.clamp(_saturating_index((x - self.origin[0]) / self.cell,
                                           H), 0, H - 2)
        iy = torch.clamp(_saturating_index((y - self.origin[1]) / self.cell,
                                           W), 0, W - 2)
        if self.min3 is not None:
            return self.min3[ix, iy]
        h = self.height
        return torch.minimum(torch.minimum(h[ix, iy], h[ix + 1, iy]),
                             h[ix, iy + 1])

    def normal(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Surface normal from central differences of the heightfield."""
        e = self.cell
        dhdx = (self.sample(x + e, y) - self.sample(x - e, y)) / (2 * e)
        dhdy = (self.sample(x, y + e) - self.sample(x, y - e)) / (2 * e)
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True)


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


# ---------------------------------------------------------------------------
# curriculum grid terrain (rows = difficulty, cols = type)


@dataclasses.dataclass
class GridTerrainCfg:
    """Leaf values of LeggedRobotCfg.terrain (legged_robot_config.py:43-66)."""

    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: Tuple[float, ...] = (0.1, 0.1, 0.35, 0.25, 0.2)
    curriculum: bool = True
    slope_threshold: float = 0.75
    # 'selected' mode (reference terrain.py:124-129 + selected_terrain):
    # every cell gets the named subterrain with these kwargs
    selected: "str | None" = None   # pyramid_slope|rough|pyramid_stairs|
    #                                 discrete_obstacles|stepping_stones|gap|pit
    selected_kwargs: dict = dataclasses.field(default_factory=dict)
    seed: int = 0


class GridTerrain(NamedTuple):
    hf: Heightfield
    env_origins: np.ndarray  # (rows, cols, 3) world spawn points
    length: float            # per-subterrain length [m]


def _pyramid_slope(h, cell, vscale, slope, platform=3.0):
    n = h.shape[0]
    c = n // 2
    x = np.abs(np.arange(n) - c)
    d = np.maximum(x[:, None], x[None, :])  # Chebyshev distance from center
    ramp = (c - d) * cell * slope
    plat_cells = int(platform / cell / 2)
    peak = (c - plat_cells) * cell * slope
    return np.minimum(ramp, peak)


def _rough(rng, h, cell, min_h=-0.05, max_h=0.05, step=0.005, down_scale=0.2):
    n = h.shape[0]
    coarse = max(int(n * cell / down_scale), 2)
    vals = rng.choice(np.arange(min_h, max_h + step, step), size=(coarse, coarse))
    # nearest-neighbor upsample
    idx = np.minimum((np.arange(n) * coarse // n), coarse - 1)
    return vals[idx][:, idx]


def _pyramid_stairs(h, cell, step_w=0.31, step_h=0.1, platform=3.0):
    n = h.shape[0]
    c = n // 2
    x = np.abs(np.arange(n) - c)
    d = np.maximum(x[:, None], x[None, :])
    step_cells = max(int(step_w / cell), 1)
    plat_cells = int(platform / cell / 2)
    n_steps = np.maximum((c - d - plat_cells), 0) // step_cells
    return n_steps * step_h


def _discrete_obstacles(rng, h, cell, height, min_size=1.0, max_size=2.0,
                        num_rects=20, platform=3.0):
    n = h.shape[0]
    out = np.zeros_like(h)
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / cell)
        l = int(rng.uniform(min_size, max_size) / cell)
        x = rng.integers(0, max(n - w, 1))
        y = rng.integers(0, max(n - l, 1))
        out[x:x + w, y:y + l] = rng.choice([-height, -height / 2, height / 2, height])
    c = n // 2
    p = int(platform / cell / 2)
    out[c - p:c + p, c - p:c + p] = 0
    return out


def _stepping_stones(rng, h, cell, stone_size, stone_dist, max_height=0.0,
                     platform=4.0, depth=-2.0):
    n = h.shape[0]
    out = np.full_like(h, depth)
    s = max(int(stone_size / cell), 1)
    d = max(int(stone_dist / cell), 1)
    y = 0
    while y < n:
        x = int(rng.integers(0, s))
        out[:, y:y + s][0:x, :] = rng.uniform(-max_height, max_height)
        while x < n:
            x2 = min(x + s, n)
            out[x:x2, y:y + s] = rng.uniform(-max_height, max_height)
            x += s + d
        y += s + d
    c = n // 2
    p = int(platform / cell / 2)
    out[c - p:c + p, c - p:c + p] = 0
    return out


def _gap(h, cell, gap_size, platform=3.0):
    n = h.shape[0]
    c = n // 2
    out = np.zeros_like(h)
    g = int(gap_size / cell)
    p = int(platform / cell / 2)
    out[c - p - g:c + p + g, c - p - g:c + p + g] = -1000 * 0.005
    out[c - p:c + p, c - p:c + p] = 0
    return out


def _pit(h, cell, depth, platform=4.0):
    n = h.shape[0]
    c = n // 2
    out = np.full_like(h, 0.0)
    p = int(platform / cell / 2)
    out[c - p:c + p, c - p:c + p] = 0
    out[:c - p, :] = -depth
    out[c + p:, :] = -depth
    out[:, :c - p] = -depth
    out[:, c + p:] = -depth
    return out


def _make_subterrain(rng, n, cfg: GridTerrainCfg, choice: float, difficulty: float):
    """Mirror of reference make_terrain difficulty scalings
    (terrain.py:172-208)."""
    cell = cfg.horizontal_scale
    h = np.zeros((n, n), np.float64)
    props = np.cumsum(cfg.terrain_proportions).tolist()
    while len(props) < 7:
        props.append(props[-1])
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    obstacle_h = 0.05 + difficulty * 0.2
    stone_size = 1.5 * (1.05 - difficulty)
    stone_dist = 0.05 if difficulty == 0 else 0.1
    gap_size = 1.0 * difficulty
    pit_depth = 1.0 * difficulty
    if choice < props[0]:
        if choice < props[0] / 2:
            slope = -slope
        h = _pyramid_slope(h, cell, cfg.vertical_scale, slope)
    elif choice < props[1]:
        h = _pyramid_slope(h, cell, cfg.vertical_scale, slope)
        h = h + _rough(rng, h, cell)
    elif choice < props[2]:
        h = _pyramid_stairs(h, cell, step_h=-step_height)
    elif choice < props[3]:
        h = _pyramid_stairs(h, cell, step_h=step_height)
    elif choice < props[4]:
        h = _discrete_obstacles(rng, h, cell, obstacle_h)
    elif choice < props[5]:
        h = _stepping_stones(rng, h, cell, stone_size, stone_dist)
    elif choice < props[6]:
        h = _gap(h, cell, gap_size)
    else:
        h = _pit(h, cell, pit_depth)
    return h


def _selected_subterrain(rng, n, cfg: GridTerrainCfg):
    """Reference selected_terrain: one named subterrain type for every
    cell, parameterized by cfg.selected_kwargs."""
    cell = cfg.horizontal_scale
    h = np.zeros((n, n), np.float64)
    kw = dict(cfg.selected_kwargs)
    name = cfg.selected
    if name == "pyramid_slope":
        return _pyramid_slope(h, cell, cfg.vertical_scale, **kw)
    if name == "rough":
        return _rough(rng, h, cell, **kw)
    if name == "pyramid_stairs":
        return _pyramid_stairs(h, cell, **kw)
    if name == "discrete_obstacles":
        return _discrete_obstacles(rng, h, cell, **kw)
    if name == "stepping_stones":
        return _stepping_stones(rng, h, cell, **kw)
    if name == "gap":
        return _gap(h, cell, **kw)
    if name == "pit":
        return _pit(h, cell, **kw)
    raise ValueError(f"unknown selected terrain {name!r}")


def grid_heights(cfg: GridTerrainCfg):
    """The (H, W) float32 height array of `grid_terrain` and its
    (rows, cols, 3) float64 spawn points."""
    rng = np.random.default_rng(cfg.seed)
    n = int(cfg.terrain_width / cfg.horizontal_scale)
    border = int(cfg.border_size / cfg.horizontal_scale)
    H = cfg.num_rows * n + 2 * border
    W = cfg.num_cols * n + 2 * border
    field = np.zeros((H, W), np.float64)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
    for i in range(cfg.num_rows):
        for j in range(cfg.num_cols):
            if cfg.selected:
                sub = _selected_subterrain(rng, n, cfg)
            elif cfg.curriculum:
                difficulty = i / cfg.num_rows
                choice = j / cfg.num_cols + 0.001
                sub = _make_subterrain(rng, n, cfg, choice, difficulty)
            else:
                difficulty = rng.choice([0.5, 0.75, 0.9])
                choice = rng.uniform(0, 1)
                sub = _make_subterrain(rng, n, cfg, choice, difficulty)
            x0 = border + i * n
            y0 = border + j * n
            field[x0:x0 + n, y0:y0 + n] = sub
            # spawn at subterrain center, on top of local max around center
            cx, cy = x0 + n // 2, y0 + n // 2
            r = int(1.0 / cfg.horizontal_scale)
            z = np.max(field[cx - r:cx + r, cy - r:cy + r])
            origins[i, j] = [
                (i + 0.5) * cfg.terrain_length,
                (j + 0.5) * cfg.terrain_width,
                z,
            ]
    # int16 quantization parity (reference keeps height_field_raw as int16
    # samples of vertical_scale metres, terrain.py:133)
    if cfg.vertical_scale > 0:
        field = np.round(field / cfg.vertical_scale) * cfg.vertical_scale
    return field.astype(np.float32), origins


def grid_terrain(cfg: GridTerrainCfg, device="cuda") -> GridTerrain:
    dev = resolve_device(device)
    field, origins = grid_heights(cfg)
    hf = heightfield_from_numpy(field, cfg.horizontal_scale,
                                (-cfg.border_size, -cfg.border_size), dev)
    return GridTerrain(hf=hf, env_origins=origins, length=cfg.terrain_length)


def heightfield_to_trimesh(hf: Heightfield, slope_threshold=None):
    """(vertices, triangles) export of a heightfield — parity with the
    external isaacgym.terrain_utils.convert_heightfield_to_trimesh the
    reference consumes (terrain.py:57-60). Used by the offline visualizer
    and deployment-mesh export; native C++ when built.

    With slope_threshold (the reference passes cfg.slope_treshold), the
    walkable-surface correction is applied: vertices on slopes steeper
    than the threshold shift horizontally so steep faces become
    near-vertical walls (stairs stay stairs instead of ramps). Collision
    samples the heightfield bilinearly, so the correction affects exported
    meshes only (PhysX collides the corrected trimesh)."""
    height = hf.height.detach().cpu().numpy()
    if slope_threshold is None:
        return native.heightfield_to_trimesh(height, hf.cell, hf.origin)
    h = height.astype(np.float64)
    H, W = h.shape
    cell = hf.cell
    thr = slope_threshold * cell
    move_x = np.zeros((H, W))
    move_y = np.zeros((H, W))
    move_c = np.zeros((H, W))
    move_x[:H - 1, :] += (h[1:, :] - h[:-1, :] > thr)
    move_x[1:, :] -= (h[:-1, :] - h[1:, :] > thr)
    move_y[:, :W - 1] += (h[:, 1:] - h[:, :-1] > thr)
    move_y[:, 1:] -= (h[:, :-1] - h[:, 1:] > thr)
    move_c[:H - 1, :W - 1] += (h[1:, 1:] - h[:-1, :-1] > thr)
    move_c[1:, 1:] -= (h[:-1, :-1] - h[1:, 1:] > thr)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = hf.origin[0] + (ii + move_x + move_c * (move_x == 0)) * cell
    ys = hf.origin[1] + (jj + move_y + move_c * (move_y == 0)) * cell
    verts = np.stack([xs.ravel(), ys.ravel(), h.ravel()], -1)
    # two triangles per cell, [v0, v3, v1] and [v0, v2, v3]
    v0 = (ii[:-1, :-1] * W + jj[:-1, :-1]).ravel()
    tris = np.empty((2 * (H - 1) * (W - 1), 3), np.uint32)
    tris[0::2] = np.stack([v0, v0 + W + 1, v0 + 1], -1)
    tris[1::2] = np.stack([v0, v0 + W, v0 + W + 1], -1)
    return verts.astype(np.float32), tris
