"""What the port's hand-written CUDA kernels share as PyTorch ops.

Each op module (ops/contact_kernel.py, ops/aba_kernel.py,
ops/fk_kernel.py) names its source under csrc/, its C entry's argument
kinds, its extra nvcc flags, its limits, its arguments' shapes and its
outputs, and follows one device rule (`Kernel.takes`): on CPU tensors the
op runs its plain PyTorch version, on CUDA tensors it launches its kernel,
and on any other device it raises ValueError. A `Kernel` owns the rest:

  * the build: nvcc compiles the source into dwbc_tpu_torch/build/ when
    the library is missing, older than its source, or the build is forced,
    through a temporary file renamed into place; a missing or failing
    nvcc raises, and nothing falls back to the plain version;
  * the load: the library opened with ctypes at the first launch, inside
    the set-up span `setup.native`, its C entry's `argtypes` set;
  * the launch on the current stream of the tensors' device, raising
    RuntimeError on a non-zero cudaError, and the one launch count: the
    span counter named after the kernel (`spans.total`, and the iteration
    records the benchmark reads).

`check` is the tensor check every op runs on its arguments before a
launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

import torch

from ..utils import spans

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build a CUDA kernel")
    return path


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless argument `name` is on `device` (ValueError), of
    `dtype` (TypeError) and of `shape` (ValueError)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


class Kernel:
    """The kernel of csrc/`source`, C entry `entry`, whose parameters
    before the trailing stream are of the ctypes kinds `argtypes`; built
    with NVCC_FLAGS and `flags` into dwbc_tpu_torch/build/lib<stem>.so.
    `name` is its launch counter's name."""

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, flags: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.library = os.path.join(
            BUILD, f"lib{os.path.splitext(source)[0]}.so")
        self.entry = entry
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.flags = [*NVCC_FLAGS, *flags]
        self._fn = None

    def build(self, force: bool = False) -> str:
        """Compile the source into the library if it is missing, older than
        its source, or `force`; returns nvcc's output (ptxas register and
        spill report) or "" when the library was up to date."""
        source, library = self.source, self.library
        if (not force and os.path.exists(library)
                and os.path.getmtime(library) >= os.path.getmtime(source)):
            return ""
        os.makedirs(os.path.dirname(library), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
        os.close(fd)
        try:
            res = subprocess.run([nvcc(), *self.flags, "-o", tmp, source],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"({res.returncode}):\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, library)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return res.stdout + res.stderr

    def _load(self):
        with spans.span("setup.native"):
            self.build()
            fn = getattr(ctypes.CDLL(self.library), self.entry)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._fn = fn
        return fn

    def takes(self, t: torch.Tensor) -> bool:
        """The device rule: True where the op launches the kernel (a CUDA
        tensor), False where it runs its plain version (a CPU tensor);
        ValueError on any other device."""
        kind = t.device.type
        if kind == "cpu":
            return False
        if kind == "cuda":
            return True
        raise ValueError(f"{self.name}: unsupported device {t.device}")

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry with `args` and the current stream of `device`;
        raise RuntimeError on a non-zero cudaError, count the launch."""
        fn = self._fn
        if fn is None:
            fn = self._load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        spans.count(self.name)
