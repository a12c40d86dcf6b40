"""Tests of the benchmark. `card` marks a test that needs a CUDA card;
whether there is one is decided inside the `cuda_device` fixture, never
while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none "
        "(run on the card: python -m pytest phylobench/tests -m card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda:0"
