"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single
real CPU device; only the dry-run subprocess uses 512 placeholder devices.
"""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
