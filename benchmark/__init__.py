"""The benchmark of dwbc_tpu_torch, the PyTorch and CUDA port.

Run one cell from the repository's root:

    python3 -m benchmark.run --workload widowGo1-5000x40 --seed 1 \
        --seconds 45 --trace 0

`BENCHMARK.json` names the cells; each is a configuration
(`configs/<name>.json`) under a traffic mix (`traffic/<name>.json`), and
each per-layer metric is read by `metrics/<name>.py`. The yardstick
(peaks, operation and byte counts, the comparison that decides
`correct`) and the plain reference (`reference/`) live here, apart from
the program they measure.
"""
