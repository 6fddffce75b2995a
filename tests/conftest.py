"""Test config: a virtual 8-device CPU mesh, so every test runs without an
accelerator. A JAX_PLATFORMS other than ``cpu`` is left in place, for the
tests marked ``gpu`` (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
on a machine with an NVIDIA GPU); elsewhere those tests skip."""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test runs on; skips the test without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
    return dev
