"""On-card suite: runs on the real GPU (no platform forcing, unlike
tests/conftest.py, which pins the CPU and x64).

    python -m pytest tests_gpu -m gpu -q

Every test carries the ``gpu`` marker and skips, with its reason, where
JAX finds no GPU; the check runs inside a fixture, never at import.
"""

import jax
import pytest


@pytest.fixture(scope="session", autouse=True)
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (the on-card suite)")
    from stein_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
