"""Peeled + sliced exact engine (core/pexact.py) vs the f64 FFT oracle.

The pexact backends must reproduce the plain f64 'fft' CPU path: smooth terms
are exact moment algebra, fluct x fluct rides the sliced pair-FFT, so at a
full SliceProfile the tables agree to machine precision and the end-to-end
solution/difference to the conditioning-amplified f64 band. Reduced profiles
degrade gracefully — bounds pinned here.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import sfft_jax  # noqa: F401  (enables x64)
from sfft_jax.config import BasisSpec, SFFTConfig
from sfft_jax.core.engine import GeneralSFFT, _normal_equations_impl


def _pair(rng, N0=80, N1=64):
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    I = 100.0 + 0.3 * xx + 0.5 * yy + 0.002 * xx * yy
    for _ in range(25):
        x0, y0 = rng.uniform(3, N0 - 3), rng.uniform(3, N1 - 3)
        amp, sig = rng.uniform(50, 400), rng.uniform(0.8, 1.8)
        I = I + amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                             / (2 * sig ** 2))
    J = I * 1.1 + 4.0 + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 0.7, I.shape)
    return I, J


def _cfg(gb, fb, N0=80, N1=64, w=3, **kw):
    return SFFTConfig(N0=N0, N1=N1, w0=w, w1=w,
                      kernel_basis=BasisSpec("polynomial", 2),
                      bg_basis=BasisSpec("polynomial", 2),
                      greek_backend=gb, fdiff_backend=fb, **kw)


@pytest.fixture(scope="module")
def pair():
    return _pair(np.random.default_rng(42))


@pytest.fixture(scope="module")
def oracle(pair):
    I, J = pair
    cfg_o = _cfg("fft", "fft")
    lhs, rhs = _normal_equations_impl(cfg_o, jnp.asarray(I), jnp.asarray(J))
    sol, diff, _ = GeneralSFFT.GSS(I, J, I, J, cfg_o)
    return (np.asarray(lhs), np.asarray(rhs), np.asarray(sol),
            np.asarray(diff))


def test_pexact_full_profile_matches_f64_oracle(pair, oracle):
    I, J = pair
    lhs_o, rhs_o, sol_o, d_o = oracle
    cfg = _cfg("pexact", "pexact", pexact_prof=(9, 8, 8))
    lhs, rhs = _normal_equations_impl(cfg, jnp.asarray(I), jnp.asarray(J))
    assert np.max(np.abs(np.asarray(lhs) - lhs_o)) < 1e-12 * np.abs(lhs_o).max()
    assert np.max(np.abs(np.asarray(rhs) - rhs_o)) < 1e-12 * np.abs(rhs_o).max()
    sol, diff, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
    # sol band = table eps * cond_eq amplification (~1e7 here)
    assert np.max(np.abs(np.asarray(sol) - sol_o)) < 1e-7 * np.abs(sol_o).max()
    dev = np.sqrt(np.mean((np.asarray(diff) - d_o) ** 2))
    assert dev < 1e-7


def test_pexact_contract_profile(pair, oracle):
    """(8, 7, 6) — the default: captures 48 bits of the fluct scale, which is
    the plain exact backend's own pair-representation floor."""
    I, J = pair
    _, _, sol_o, d_o = oracle
    cfg = _cfg("pexact", "pexact")          # default prof (8, 7, 6)
    sol, diff, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
    assert np.max(np.abs(np.asarray(sol) - sol_o)) < 1e-6 * np.abs(sol_o).max()
    assert np.sqrt(np.mean((np.asarray(diff) - d_o) ** 2)) < 1e-7


def test_pexact_balanced_profile(pair, oracle):
    """(6, 6, 5) — a reduced profile (~36-bit fluct capture)."""
    I, J = pair
    _, _, sol_o, d_o = oracle
    cfg = _cfg("pexact", "pexact", pexact_prof=(6, 6, 5))
    sol, diff, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
    assert np.max(np.abs(np.asarray(sol) - sol_o)) < 1e-4 * np.abs(sol_o).max()
    assert np.sqrt(np.mean((np.asarray(diff) - d_o) ** 2)) < 1e-5


def test_pexact_separate_varying(pair):
    I, J = pair
    sv = dict(scaling_basis=BasisSpec("polynomial", 1))
    cfg_o = _cfg("fft", "fft", **sv)
    cfg_p = _cfg("pexact", "pexact", pexact_prof=(9, 8, 8), **sv)
    sol_o, d_o, _ = GeneralSFFT.GSS(I, J, I, J, cfg_o)
    sol_p, d_p, _ = GeneralSFFT.GSS(I, J, I, J, cfg_p)
    sol_o, sol_p = np.asarray(sol_o), np.asarray(sol_p)
    assert np.max(np.abs(sol_p - sol_o)) < 1e-6 * np.abs(sol_o).max()
    assert np.sqrt(np.mean((np.asarray(d_p) - np.asarray(d_o)) ** 2)) < 1e-6


def test_pexact_rejects_bspline():
    cfg = SFFTConfig(N0=64, N1=64, w0=3, w1=3,
                     kernel_basis=BasisSpec("bspline", 2,
                                            int_knots_x=(32.0,),
                                            int_knots_y=(32.0,)),
                     bg_basis=BasisSpec("polynomial", 2),
                     greek_backend="pexact", fdiff_backend="pexact")
    from sfft_jax.core.pexact import pexact_supported

    assert not pexact_supported(cfg)
    with pytest.raises(ValueError, match="polynomial"):
        GeneralSFFT.GSS(*(np.zeros((64, 64)),) * 4, cfg)


@pytest.mark.parametrize("variant", ["sep-const", "no-cpr"])
def test_pexact_other_scaling_modes(pair, variant):
    """SEPARATE-CONSTANT and ENTANGLED/ConstPhotRatio=False ride the same
    union/entangled algebra — pin them against the f64 oracle too."""
    I, J = pair
    kw = (dict(scaling_basis=BasisSpec("polynomial", 0))
          if variant == "sep-const" else dict(const_phot_ratio=False))
    cfg_o = _cfg("fft", "fft", **kw)
    cfg_p = _cfg("pexact", "pexact", pexact_prof=(9, 8, 8), **kw)
    sol_o, d_o, _ = GeneralSFFT.GSS(I, J, I, J, cfg_o)
    sol_p, d_p, _ = GeneralSFFT.GSS(I, J, I, J, cfg_p)
    sol_o, sol_p = np.asarray(sol_o), np.asarray(sol_p)
    assert np.max(np.abs(sol_p - sol_o)) < 1e-6 * np.abs(sol_o).max()
    assert np.sqrt(np.mean((np.asarray(d_p) - np.asarray(d_o)) ** 2)) < 1e-6
