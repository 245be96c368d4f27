"""Test config: the CPU backend with an 8-device virtual mesh.

Sharded code paths (distributed BA) run everywhere on
``--xla_force_host_platform_device_count=8`` CPU devices.  The platform
is pinned to the CPU unless ``JAX_PLATFORMS`` says otherwise, which is
how the ``gpu``-marked tests reach the card::

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

Whether a card is present is decided inside the ``gpu`` fixture, never
at import time, so every worker collects the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu, on the card)")
    return devs[0]
