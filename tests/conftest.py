"""Test environment: CPU backend, 8 virtual devices, float64 parity mode.

The platform is pinned to the CPU unless ``JAX_PLATFORMS`` names one.
Tests that need a GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them when JAX finds no GPU; on a machine with a card
they run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips where JAX finds none)"
    )


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.RandomState(0)
