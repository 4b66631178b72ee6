"""Test config: tests run on the CPU backend (JAX_PLATFORMS=cpu), on a
virtual 8-device CPU host so sharding paths are exercised without GPUs.

Tests marked ``gpu`` need an NVIDIA GPU and skip without one; run them on
the card with ``python -m pytest -m gpu`` (chip_smoke.py does, in its own
process).  Only that selection leaves JAX on its default backend.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


def pytest_configure(config):
    if (config.getoption("markexpr") or "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def factory():
    from mediastreamer2_tpu.core.factory import Factory
    return Factory()


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (found {dev.platform}); run "
                    f"`python -m pytest -m gpu` on the card")
    return dev


from mediastreamer2_tpu.utils.signals import make_speechlike  # noqa: F401,E402
