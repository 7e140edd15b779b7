"""Tests that need an NVIDIA GPU. The `gpu_device` fixture skips them
elsewhere; `python chip_smoke.py` runs them on the card, in its own
process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sfft_jax  # noqa: F401  (enables x64)
from sfft_jax import make_config
from sfft_jax.core.engine import solve_and_subtract_same_fn
from sfft_jax.utils.synth import star_pair

pytestmark = pytest.mark.gpu


def test_native_f64_primitives_on_gpu(gpu_device):
    """complex128 FFT and f64 LU run on the card at f64 accuracy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 256))
    A = rng.normal(size=(300, 300)) + 300 * np.eye(300)
    b = rng.normal(size=300)
    with jax.default_device(gpu_device):
        spec = jnp.fft.rfft2(jnp.asarray(x))
        sol = jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b))
    assert spec.dtype == jnp.complex128
    assert next(iter(spec.devices())).platform == "gpu"
    ref = np.fft.rfft2(x)
    assert np.max(np.abs(np.asarray(spec) - ref)) < 1e-12 * np.max(np.abs(ref))
    assert np.max(np.abs(A @ np.asarray(sol) - b)) < 1e-12


def test_default_step_gpu_matches_cpu(gpu_device):
    """The default fused step on the card agrees with the CPU device."""
    n = 256
    I, J = star_pair(n, n, seed=7)
    step = jax.jit(solve_and_subtract_same_fn(make_config(n, n, 4)))
    with jax.default_device(gpu_device):
        sol_g, diff_g = step(I, J)
        assert next(iter(diff_g.devices())).platform == "gpu"
    with jax.default_device(jax.devices("cpu")[0]):
        sol_c, diff_c = step(I, J)
    e = np.asarray(diff_g) - np.asarray(diff_c)
    assert np.sqrt(np.mean(e * e)) < 1e-6


def test_corr_window_methods_agree_on_gpu(gpu_device):
    from sfft_jax.core.greek import corr_window_fft

    rng = np.random.default_rng(2)
    with jax.default_device(gpu_device):
        A = jnp.fft.rfft2(jnp.asarray(rng.normal(size=(3, 128, 96))))
        m = corr_window_fft(A, A, 128, 96, 4, 4, method="matmul",
                            symmetric=True)
        i = corr_window_fft(A, A, 128, 96, 4, 4, method="irfft")
    np.testing.assert_allclose(np.asarray(m), np.asarray(i),
                               atol=1e-12 * float(jnp.max(jnp.abs(i))))
