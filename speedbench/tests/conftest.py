"""Tests of the benchmark itself: `python3 -m pytest speedbench/tests`.
Tests marked `chip` need a CUDA card and skip without one (decided inside
the test, by the `card` fixture)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return "cuda"
