"""Test configuration.

The suite runs on whatever backend JAX picks (the CPU in CI). ``XLA_FLAGS``
forces 8 virtual CPU devices for the sharding tests, which take them
explicitly via ``jax.devices("cpu")``. Tests that need a GPU carry the
``gpu`` marker and take the ``gpu_device`` fixture, which skips them when
the default device is not a GPU — decided at run time, never at import.

Compile frugality matters: XLA CPU compiles can take ~20s each — share
capacities/configs across parametrized cases so jitted programs are reused.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# SURVEY.md §5.2: run the whole suite under NaN debugging — any jitted
# function returning a NaN fails loudly instead of corrupting physics
# downstream. Cost is one output scan per call; masked-lane garbage inside
# kernels is fine as long as the *outputs* are clean, which is the contract.
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def cpu_devices():
    """8 virtual CPU devices for sharding tests (exist on every backend)."""
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "xla_force_host_platform_device_count not applied"
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The default device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
