"""Build a CUDA source of csrc/ into a shared library with nvcc, and load
it with ctypes.

Each kernel's wrapper (ops/contact_kernel.py, ops/aba_kernel.py) names its
source, its library under dwbc_tpu_torch/build/ and its own nvcc flags.
A library is rebuilt when it is missing or older than its source; a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

from ..utils import spans

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build a CUDA kernel")
    return path


def build(source: str, library: str, flags: Sequence[str],
          force: bool = False) -> str:
    """Compile `source` into `library` if it is missing, older than its
    source, or `force`; returns nvcc's output (ptxas register and spill
    report) or "" when the library was up to date."""
    if (not force and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return ""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    try:
        res = subprocess.run([nvcc(), *flags, "-o", tmp, source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):"
                               f"\n{res.stdout}{res.stderr}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr


def load(source: str, library: str, flags: Sequence[str]) -> ctypes.CDLL:
    """`build`, then open the library (set-up span `setup.native`)."""
    with spans.span("setup.native"):
        build(source, library, flags)
        return ctypes.CDLL(library)
