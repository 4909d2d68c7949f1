"""Test configuration: run everything on the CPU with 8 fake devices so the
sharded paths (stein_jax.parallel) are exercised without accelerators, and
enable x64 so golden-trajectory tests can compare against the float64 NumPy
oracle bit-tightly.

The platform is selected through jax.config before any backend
initialisation; the on-card suite lives in tests_gpu/.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def eight_devices():
    """Skip (inside the test, never at collection) unless 8 devices."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 fake CPU devices")
