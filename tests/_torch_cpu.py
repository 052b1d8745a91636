"""Shared fixture of the PyTorch port's tests (``tests/test_torch_*.py``).

The port's tests run tiny tensors, which gain nothing from torch's
intra-op thread pool, while the suite runs several pytest workers at
once: one torch thread per worker keeps them from oversubscribing the
cores (and runs these files faster even alone).
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
