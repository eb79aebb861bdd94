"""Tests of the port's benchmark (``python -m pytest portbench/tests``).

They run on the CPU at small sizes; a test marked ``card`` needs a CUDA
card and skips without one, deciding inside the test."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
