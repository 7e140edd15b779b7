"""Test environment: CPU backend with 8 virtual devices, x64 enabled.

The tests run on the CPU. Env vars alone do not pin the platform once a
plugin registers another backend, so the platform also goes through
jax.config before the first backend use. Tests marked `gpu` need a card:
the `gpu_device` fixture skips them here, and chip_smoke.py runs them on the
card inside its own process with SFFT_TESTS_ON_GPU=1, which leaves the
platform alone. The persistent compilation cache is off for CPU test runs.
"""

import os

ON_GPU = os.environ.get("SFFT_TESTS_ON_GPU") == "1"

if not ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX's first device is "
                    f"{dev.platform!r})")
    return dev
