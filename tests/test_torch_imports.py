"""dwbc_tpu_torch stands alone: every module imports with JAX, flax and
optax blocked, and no source line of the package or of chip_smoke.py
imports the JAX package."""

import os
import re
import subprocess
import sys

import dwbc_tpu_torch

PKG_DIR = os.path.dirname(os.path.abspath(dwbc_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)

_PROBE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dwbc_tpu"):
    sys.modules[name] = None   # any import of these now raises
import importlib, pkgutil
import dwbc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dwbc_tpu_torch.__path__,
                                               "dwbc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_package_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_no_source_imports_the_jax_package():
    imports = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|dwbc_tpu)(?!\w)")
    by_name = re.compile(
        r"(?:import_module|__import__)\(\s*[\"'](?:jax|flax|optax|dwbc_tpu)(?!\w)")
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 30
    offenders = []
    for path in sources:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if imports.search(line) or by_name.search(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
