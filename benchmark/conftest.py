"""Test settings of the benchmark's own tests (``python -m pytest
benchmark``): the ``cuda`` marker, and a fixture that skips a test
marked with it where no CUDA device is found."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)
