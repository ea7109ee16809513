"""The benchmark's own pytest settings: the `cuda` marker for tests that
need the card, and the fixture that skips them without one (decided when
the test runs, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")
