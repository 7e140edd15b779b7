"""Peeled (mixed-precision) Greek backend vs the exact FFT backend.

With fluct_dtype='float64' the peeled backend must reproduce the plain f64 FFT
backend almost exactly (validates all the moment/wrap/shift algebra). With
fluct_dtype='float32' it must stay accurate enough that solutions and
difference images are scientifically equivalent — that is fast mode.
"""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.config import SFFTConfig, BasisSpec
from sfft_jax.core.engine import ElementalSFFT, _plane_stacks
from sfft_jax.core.greek import greek_tables
from sfft_jax.core.peel import peeled_greek_tables

import jax.numpy as jnp


def make_pair(rng, N0=48, N1=40, mean=500.0):
    """Pair with a LARGE smooth background — the cancellation stress case."""
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    I = mean * (1.0 + 0.3 * xx / N0 + 0.5 * (yy / N1) ** 2)
    for _ in range(15):
        x0, y0 = rng.uniform(3, N0 - 3), rng.uniform(3, N1 - 3)
        I = I + rng.uniform(100, 600) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * rng.uniform(0.8, 1.5) ** 2)
        )
    J = 1.1 * I + 0.02 * mean * (xx / N0) + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 1.0, I.shape)
    return I, J


def cfg_for(N0, N1, w, backend, fluct="float64", peel=3):
    return SFFTConfig(
        N0=N0, N1=N1, w0=w, w1=w,
        kernel_basis=BasisSpec("polynomial", 2),
        bg_basis=BasisSpec("polynomial", 2),
        greek_backend=backend, fluct_dtype=fluct, peel_degree=peel,
    )


@pytest.mark.parametrize("w", [1, 2, 3])
def test_peeled_tables_exact_f64(rng, w):
    I, J = make_pair(rng)
    cfg = cfg_for(48, 40, w, "peeled", fluct="float64")
    t_peel = peeled_greek_tables(jnp.asarray(I), jnp.asarray(J), cfg)

    cfg_ref = cfg_for(48, 40, w, "fft")
    SI, ST, _ = _plane_stacks(cfg_ref, jnp.asarray(I))
    t_ref = greek_tables(SI, ST, jnp.asarray(J), w, w, backend="fft")

    names = ["Comg", "Cgam", "Cthe", "Cphi", "Cdel"]
    for name, a, b in zip(names, t_peel, t_ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max()
        assert np.allclose(a, b, atol=1e-9 * scale), (
            f"{name}: max abs diff {np.abs(a-b).max():.3e} vs scale {scale:.3e}"
        )


def test_peeled_solution_exact_f64(rng):
    I, J = make_pair(rng)
    cfg_p = cfg_for(48, 40, 2, "peeled", fluct="float64")
    cfg_r = cfg_for(48, 40, 2, "fft")
    sol_p, _ = ElementalSFFT.ESS(I, J, cfg_p)
    sol_r, _ = ElementalSFFT.ESS(I, J, cfg_r)
    sol_p, sol_r = np.asarray(sol_p), np.asarray(sol_r)
    assert np.allclose(sol_p, sol_r, rtol=1e-6, atol=1e-7 * np.abs(sol_r).max())


def test_peeled_mixed_precision_quality(rng):
    """float32 fluct path: solution must stay scientifically close to f64 even
    with a large smooth background (the case where raw f32 assembly fails)."""
    I, J = make_pair(rng, mean=2000.0)
    cfg_r = cfg_for(48, 40, 2, "fft")
    sol_r, diff_r = ElementalSFFT.ESS(I, J, cfg_r, Subtract=True)

    cfg_m = cfg_for(48, 40, 2, "peeled", fluct="float32")
    sol_m, diff_m = ElementalSFFT.ESS(I, J, cfg_m, Subtract=True)

    diff_r, diff_m = np.asarray(diff_r), np.asarray(diff_m)
    # the difference images should agree to far below the noise level (sigma=1)
    err = np.sqrt(np.mean((diff_r - diff_m) ** 2))
    assert err < 0.05, f"mixed-precision diff error RMS {err:.3g}"


def test_peel_degree_invariance(rng):
    """The peel is exact algebra: with f64 fluct the result must not depend on
    the peel degree."""
    I, J = make_pair(rng)
    sols = []
    for d in [1, 2, 4]:
        cfg = cfg_for(48, 40, 1, "peeled", fluct="float64", peel=d)
        sol, _ = ElementalSFFT.ESS(I, J, cfg)
        sols.append(np.asarray(sol))
    assert np.allclose(sols[0], sols[1], rtol=1e-6, atol=1e-7 * np.abs(sols[0]).max())
    assert np.allclose(sols[0], sols[2], rtol=1e-6, atol=1e-7 * np.abs(sols[0]).max())


def test_corr_window_matmul_equals_irfft(rng):
    """Partial-iDFT window extraction must match the full irfft2 + gather."""
    import jax.numpy as jnp
    from sfft_jax.core.greek import corr_window_fft

    A = rng.normal(10, 3, (4, 48, 40))
    spec = jnp.fft.rfft2(jnp.asarray(A))
    out_ir = corr_window_fft(spec, spec, 48, 40, 5, 4, method="irfft")
    out_mm = corr_window_fft(spec, spec, 48, 40, 5, 4, method="matmul")
    np.testing.assert_allclose(np.asarray(out_mm), np.asarray(out_ir),
                               rtol=1e-10, atol=1e-8)
    out_mm_c = corr_window_fft(spec, spec, 48, 40, 5, 4, method="matmul",
                               chunk=5)
    np.testing.assert_allclose(np.asarray(out_mm_c), np.asarray(out_ir),
                               rtol=1e-10, atol=1e-8)


def test_peeled_separate_varying(rng):
    """Peeled backend covers SEPARATE-VARYING polynomial scaling exactly."""
    I, J = make_pair(rng)
    base = dict(N0=48, N1=40, w0=2, w1=2,
                kernel_basis=BasisSpec("polynomial", 2),
                bg_basis=BasisSpec("polynomial", 1),
                scaling_basis=BasisSpec("polynomial", 1))
    cfg_ref = SFFTConfig(**base, greek_backend="fft")
    cfg_peel = SFFTConfig(**base, greek_backend="peeled",
                          fluct_dtype="float64", peel_degree=3)
    s_ref, d_ref = ElementalSFFT.ESS(I, J, cfg_ref, Subtract=True)
    s_peel, d_peel = ElementalSFFT.ESS(I, J, cfg_peel, Subtract=True)
    s_ref, s_peel = np.asarray(s_ref), np.asarray(s_peel)
    assert np.allclose(s_peel, s_ref, rtol=1e-6, atol=1e-7 * np.abs(s_ref).max())
    np.testing.assert_allclose(np.asarray(d_peel), np.asarray(d_ref),
                               atol=1e-8 * np.abs(np.asarray(d_ref)).max())
