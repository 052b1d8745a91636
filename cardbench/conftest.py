"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``card`` that need an NVIDIA GPU (they skip, inside a fixture, where
there is none)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
