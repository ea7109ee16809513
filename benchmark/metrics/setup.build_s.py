"""setup.build_s: seconds of the program's set-up spans (`setup.env`,
`setup.runner`, `setup.native` where it runs outside the others: the
env's and the runner's construction, the native libraries' build or
load), each counted once where they nest (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_seconds()
