"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`. Tests
that need a card carry the `cuda` marker and skip here (the `card`
fixture decides)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")
