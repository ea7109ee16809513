"""Nothing the benchmark runs loads JAX or the JAX package: the harness,
the reference and the port's training entry are imported, and a runner of
each configuration built, in a fresh process on the CPU."""

import json
import subprocess
import sys

from benchmark import cells

SCRIPT = """
import json, sys
from benchmark import run, calibrate, check, faults, trace, cells
from benchmark.entries import on_policy
from benchmark.reference import precision
for c in sorted({w["config"] for w in cells.benchmark_json()["workloads"]}):
    import json as j
    cfg = j.load(open(f"benchmark/configs/{c}.json"))
    for pkg in (on_policy.PROGRAM, on_policy.REFERENCE):
        on_policy.Session(pkg, cfg, {"num_envs": 2, "num_steps_per_env": 2},
                          1, "cpu")
for name in [m["name"] for m in cells.benchmark_json()["per_layer"]]:
    cells.reader(name)
print(json.dumps({"modules": sorted(sys.modules),
                  "forbidden": run.forbidden_modules()}))
"""


def test_no_jax_nor_the_jax_package_is_loaded():
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
           "HOME": cells.ROOT}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in got["modules"]}
    # whole top-level names: dwbc_tpu_torch is the port, dwbc_tpu is not
    assert "dwbc_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "dwbc_tpu"}
    assert "dwbc_tpu_torch.bench" not in got["modules"]
    assert got["forbidden"] == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "dwbc_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "dwbc_tpu_torch.bench_like", sys)
    assert "dwbc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dwbc_tpu_torch.bench", sys)
    assert "dwbc_tpu_torch.bench" in run.forbidden_modules()
