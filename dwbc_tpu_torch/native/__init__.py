"""Native (C++) host-side terrain code, loaded with ctypes.

The port's own copy of the JAX package's native layer (src/terrain.cpp):
built from source with g++ at first use into native/lib/ (git-ignored),
or by `build()` (the JAX package's native/build.py), with the same flags
as the JAX package, so both packages draw the same Perlin heightfield
from the same seed.

  * fractal_noise(...)          — multi-octave gradient Perlin heightfield;
  * heightfield_to_trimesh(...) — vertices/triangles for export and viz.

Without a working g++ the callers use numpy instead (the Perlin generator
of terrain/terrain.py, the trimesh code below), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "terrain.cpp")
LIB_PATH = os.path.join(_DIR, "lib", "libdwbc_torch_terrain.so")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def build() -> str:
    """Compile src/terrain.cpp into LIB_PATH. The library is written to a
    temporary file and renamed into place, so a process that loads it
    while another builds never sees a partial file."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIB_PATH))
    os.close(fd)
    try:
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-fopenmp", "-o", tmp, _SRC], check=True,
                           capture_output=True)
        except subprocess.CalledProcessError:
            # minimal toolchains: no OpenMP / -march
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                           check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built if missing or older than its source;
    None when it cannot be built or loaded."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if (not os.path.exists(LIB_PATH)
                or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
            build()
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.CalledProcessError):  # no g++ / no build
        _load_failed = True
        return None
    lib.dwbc_fractal_noise.restype = ctypes.c_int
    lib.dwbc_fractal_noise.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_uint64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.dwbc_heightfield_to_trimesh.restype = None
    lib.dwbc_heightfield_to_trimesh.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def fractal_noise(x_samples: int, y_samples: int, x_scale: int, y_scale: int,
                  z_scale: float, octaves: int = 2, lacunarity: float = 2.0,
                  gain: float = 0.25, seed: int = 0) -> Optional[np.ndarray]:
    """Native fractal Perlin (x_samples, y_samples) float32; None if the
    library is unavailable or the resolution does not divide the grid
    (the caller then uses the numpy generator)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((x_samples, y_samples), np.float32)
    rc = lib.dwbc_fractal_noise(x_samples, y_samples, x_scale, y_scale,
                                float(z_scale), octaves, float(lacunarity),
                                float(gain), seed & (2**64 - 1), out)
    return out if rc == 0 else None


def heightfield_to_trimesh(height: np.ndarray, cell: float,
                           origin: Tuple[float, float]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (H*W, 3) f32, triangles (2(H-1)(W-1), 3) i32). Native when
    available, numpy otherwise: identical output either way."""
    h = np.ascontiguousarray(height, np.float32)
    H, W = h.shape
    lib = _load()
    if lib is not None:
        verts = np.empty((H * W, 3), np.float32)
        tris = np.empty((2 * (H - 1) * (W - 1), 3), np.int32)
        lib.dwbc_heightfield_to_trimesh(h, H, W, float(cell),
                                        float(origin[0]), float(origin[1]),
                                        verts, tris)
        return verts, tris
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
