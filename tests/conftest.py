"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
single CPU device; only the dry-run subprocesses fake 512 devices."""

import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card"
    )
