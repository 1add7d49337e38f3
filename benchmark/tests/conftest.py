"""Tests of the benchmark. Those marked ``card`` need a CUDA card and skip
without one; they run on the card with

    python3 -m pytest benchmark/tests -q -m card --confcutdir=benchmark

(``--confcutdir`` keeps the repository's root conftest, which loads JAX for
the JAX package's tests, out of the process)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")
