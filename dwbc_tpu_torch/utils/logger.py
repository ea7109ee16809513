"""Run logging utilities: `log_files` snapshots the package's sources into
the run directory for reproducibility (reference logger.py:39-58).
Counterpart of dwbc_tpu/utils/logger.py's function of the same name."""

from __future__ import annotations

import os
import shutil


def log_files(log_dir: str, repo_root: str | None = None) -> None:
    """Snapshot the dwbc_tpu_torch sources (Python and CUDA/C++) into
    <log_dir>/src."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = repo_root or os.path.dirname(pkg)
    pkg = os.path.join(repo_root, os.path.basename(pkg))
    dst = os.path.join(log_dir, "src")
    os.makedirs(dst, exist_ok=True)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                rel = os.path.relpath(os.path.join(dirpath, f), repo_root)
                out = os.path.join(dst, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copy2(os.path.join(dirpath, f), out)
