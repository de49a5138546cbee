"""Test configuration.

Tests run on the CPU backend (``JAX_PLATFORMS=cpu``, the default set
here) with 8 virtual devices, so mesh and sharding tests compile and run
as they would across devices. Tests marked ``gpu`` take the ``gpu``
fixture and skip unless JAX finds a GPU; run them on the GPU machine
with ``JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU; skips otherwise."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {device.platform}")
    return device
