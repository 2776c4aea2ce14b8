"""Registers the ``card`` marker (tests that need a CUDA card decide inside
the test, through the ``card`` fixture, and skip without one)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided "
        "inside the test)")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
