"""The fractal Perlin heightfield in plain Python and numpy.

The port draws widowGo1's terrain with a C++ generator whose random
stream is splitmix64-seeded xoshiro256++ (dwbc_tpu_torch/native/src/
terrain.cpp). The reference rebuilds the same heights from the same seed
without that library: the stream is drawn here in Python integers, and
the octaves are summed in float64 and accumulated in float32 in the
generator's order. Only the last bit of a cosine or of a fused
multiply-add can differ, below the float32 rounding of every sample.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

_M = (1 << 64) - 1


def _uniforms(seed: int, n: int, state=None):
    """n draws in [0, 1) of xoshiro256++ seeded by splitmix64(seed), and
    the generator's state after them (pass it back to continue)."""
    if state is None:
        x = seed & _M
        state = []
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & _M
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M
            state.append(z ^ (z >> 31))
    s0, s1, s2, s3 = state
    out = [0] * n
    for i in range(n):
        t = (s0 + s3) & _M
        out[i] = ((((t << 23) | (t >> 41)) & _M) + s0) & _M
        t = (s1 << 17) & _M
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = ((s3 << 45) | (s3 >> 19)) & _M
    draws = (np.array(out, dtype=np.uint64) >> np.uint64(11)).astype(
        np.float64) * 2.0 ** -53
    return draws, [s0, s1, s2, s3]


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def fractal_noise(x_samples: int, y_samples: int, x_scale: int, y_scale: int,
                  z_scale: float, octaves: int = 2, lacunarity: float = 2.0,
                  gain: float = 0.25, seed: int = 0) -> Optional[np.ndarray]:
    """(x_samples, y_samples) float32 heights; None where the resolution
    does not divide the grid (as the generator refuses it)."""
    if x_samples <= 0 or y_samples <= 0 or octaves <= 0:
        return None
    out = np.zeros((x_samples, y_samples), np.float32)
    state = None
    amp = 1.0
    rx, ry = x_scale, y_scale
    z = float(np.float32(z_scale))
    k = math.sqrt(2.0) * 0.5
    for _ in range(octaves):
        if rx <= 0 or ry <= 0 or x_samples % rx or y_samples % ry:
            return None
        u, state = _uniforms(seed, (rx + 1) * (ry + 1), state)
        a = (2.0 * math.pi * u).reshape(rx + 1, ry + 1)
        gx, gy = np.cos(a), np.sin(a)
        dx, dy = x_samples // rx, y_samples // ry
        i = np.arange(x_samples)
        j = np.arange(y_samples)
        ci, cj = i // dx, j // dy
        fx = ((i - ci * dx) * (1.0 / dx))[:, None]
        fy = ((j - cj * dy) * (1.0 / dy))[None, :]
        uu, vv = _fade(fx), _fade(fy)
        r0, r1 = ci[:, None], ci[:, None] + 1
        c0, c1 = cj[None, :], cj[None, :] + 1
        n00 = fx * gx[r0, c0] + fy * gy[r0, c0]
        n10 = (fx - 1.0) * gx[r1, c0] + fy * gy[r1, c0]
        n01 = fx * gx[r0, c1] + (fy - 1.0) * gy[r0, c1]
        n11 = (fx - 1.0) * gx[r1, c1] + (fy - 1.0) * gy[r1, c1]
        n0 = n00 * (1.0 - uu) + uu * n10
        n1 = n01 * (1.0 - uu) + uu * n11
        val = k * ((1.0 - vv) * n0 + vv * n1) + 0.5
        out += ((amp * z) * val).astype(np.float32)
        amp *= gain
        rx, ry = int(lacunarity * rx), int(lacunarity * ry)
    return out


def heightfield_to_trimesh(height: np.ndarray, cell: float,
                           origin: Tuple[float, float]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (H*W, 3) f32, triangles (2(H-1)(W-1), 3) i32)."""
    h = np.ascontiguousarray(height, np.float32)
    H, W = h.shape
    xx, yy = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    verts = np.stack([origin[0] + xx.ravel() * cell,
                      origin[1] + yy.ravel() * cell,
                      h.ravel()], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(H - 1), np.arange(W - 1), indexing="ij")
    a = (ii * W + jj).ravel()
    b = a + 1
    c = a + W
    d = c + 1
    tris = np.empty((2 * (H - 1) * (W - 1), 3), np.int32)
    tris[0::2] = np.stack([a, b, c], -1)
    tris[1::2] = np.stack([b, d, c], -1)
    return verts, tris
