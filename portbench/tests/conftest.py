"""Puts the benchmark's modules and the port on the path, and registers the
``card`` marker of the tests that need a CUDA card (the ``card`` fixture
skips them where there is none)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for path in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the chip")
    return torch.device("cuda")
