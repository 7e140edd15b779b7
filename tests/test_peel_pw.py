"""Piecewise-polynomial (truncated-power) peel: bruteforce + parity tests.

Validates core/peel_pw.py bottom-up: 1D truncated-power reps against evaluated
B-spline tables, the windowed-correlation identity against rolled bruteforce
sums, the B-side basis contraction, and full end-to-end solution parity with
the exact f64 FFT backend for every scaling mode.
"""

import numpy as np
import pytest
from scipy import ndimage as ndi

import jax
import jax.numpy as jnp

from sfft_jax.api.bspline import make_bspline_config
from sfft_jax.core.basis import _bspline_basis_values, scaled_coords_1d
from sfft_jax.core.engine import solve_and_subtract_fn
from sfft_jax.core.peel_pw import (
    bspline_axis_reps, pw_axis, pw_moment_set, pw_corr, pw_contract_basis,
)


def brute_cc(A, B, w0, w1):
    out = np.zeros((2 * w0 + 1, 2 * w1 + 1))
    for i, r in enumerate(range(-w0, w0 + 1)):
        for j, e in enumerate(range(-w1, w1 + 1)):
            out[i, j] = np.sum(A * np.roll(B, (-r, -e), axis=(0, 1)))
    return out


def test_truncated_power_reps_match_bspline_tables():
    N, k = 300, 3
    int_knots = (100.0, 180.5, 240.0)
    thr, reps = bspline_axis_reps(int_knots, k, N)
    c = scaled_coords_1d(N)
    vals = _bspline_basis_values(c, int_knots, k, N)
    recon = np.zeros_like(vals)
    for m, T in enumerate(thr):
        for p in range(reps.shape[2]):
            w = np.zeros(N)
            w[T:] = c[T:] ** p
            recon += np.outer(w, reps[:, m, p])
    assert np.abs(recon - vals).max() < 1e-12
    assert np.abs(recon.sum(axis=1) - 1.0).max() < 1e-12  # partition of unity


def test_pw_corr_identity_bruteforce():
    rng = np.random.default_rng(11)
    N0, N1, w0, w1 = 96, 112, 3, 4
    thr0, thr1 = (0, 30, 60), (0, 45, 80)
    SP, SG = 4, 6
    ax0 = pw_axis(N0, w0, thr0, SP, SG + SP + 2)
    ax1 = pw_axis(N1, w1, thr1, SP, SG + SP + 2)
    M0, M1 = len(thr0), len(thr1)
    G = rng.normal(1000.0, 40.0, (N0, N1))

    def wset(thr, c, N):
        return np.stack([np.stack([np.where(np.arange(N) >= T, c**p, 0.0)
                                   for p in range(SP)]) for T in thr])

    A2 = rng.normal(size=(3, M0, SP, M1, SP))
    planes = np.einsum("amslt,msx,lty->axy", A2, wset(thr0, ax0.c, N0),
                       wset(thr1, ax1.c, N1))
    mom = pw_moment_set(jnp.asarray(G), ax0, ax1, SG)
    got = np.asarray(pw_corr(jnp.asarray(A2), mom, ax0, ax1))
    for a in range(3):
        ref = brute_cc(planes[a], G, w0, w1)
        rel = np.abs(got[a] - ref) / np.maximum(np.abs(ref), 1e-10)
        assert rel.max() < 1e-10


def test_pw_basis_contraction_bruteforce():
    rng = np.random.default_rng(5)
    N0 = N1 = 128
    w0 = w1 = 3
    k = 3
    thrx, repx = bspline_axis_reps((50.0,), k, N0)
    thry, repy = bspline_axis_reps((80.0,), k, N1)
    SPA = 4
    SG = SPA + k
    ax0 = pw_axis(N0, w0, thrx, SPA, SG + SPA + 2)
    ax1 = pw_axis(N1, w1, thry, SPA, SG + SPA + 2)
    M0, M1 = len(thrx), len(thry)
    G = rng.normal(0.0, 1.0, (N0, N1))

    def wset(thr, c, N):
        return np.stack([np.stack([np.where(np.arange(N) >= T, c**p, 0.0)
                                   for p in range(SPA)]) for T in thr])

    A2 = rng.normal(size=(2, M0, SPA, M1, SPA))
    planesA = np.einsum("amslt,msx,lty->axy", A2, wset(thrx, ax0.c, N0),
                        wset(thry, ax1.c, N1))
    pairs = [(0, 0), (2, 1), (1, 3)]
    Ux = _bspline_basis_values(ax0.c, (50.0,), k, N0)
    Vy = _bspline_basis_values(ax1.c, (80.0,), k, N1)
    mom = pw_moment_set(jnp.asarray(G), ax0, ax1, SG)
    momb = pw_contract_basis(
        mom, np.stack([repx[i] for i, _ in pairs]),
        np.stack([repy[j] for _, j in pairs]), ax0, ax1, SPA)
    got = np.asarray(pw_corr(jnp.asarray(A2), momb, ax0, ax1))
    for bi, (i, j) in enumerate(pairs):
        Gb = G * np.outer(Ux[:, i], Vy[:, j])
        for a in range(2):
            ref = brute_cc(planesA[a], Gb, w0, w1)
            rel = np.abs(got[a, bi] - ref) / np.abs(ref).max()
            assert rel.max() < 1e-11


@pytest.mark.parametrize("mode_kw", [
    dict(SEPARATE_SCALING=False),
    dict(SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=0),
    dict(SEPARATE_SCALING=True, ScaSpType="B-Spline", ScaSpDegree=1,
         ScaIntKnotX=[100.0], ScaIntKnotY=[128.0]),
], ids=["entangled", "sep-const", "sep-varying"])
def test_pw_peel_solution_parity(mode_kw):
    """peeled (truncated-power) backend == exact f64 FFT backend end to end
    for B-spline kernel + background bases."""
    rng = np.random.default_rng(3)
    N = 256
    base = rng.normal(1000.0, 30.0, (N, N))
    I = base + rng.normal(0, 5.0, (N, N))
    J = (ndi.gaussian_filter(base, 1.0, mode="wrap") * 1.03 + 5.0
         + rng.normal(0, 5.0, (N, N)))

    def run(greek):
        cfg = make_bspline_config(
            N, N, GKerHW=4,
            KerSpType="B-Spline", KerSpDegree=2,
            KerIntKnotX=[100.0], KerIntKnotY=[128.0],
            BkgSpType="B-Spline", BkgSpDegree=2,
            BkgIntKnotX=[100.0], BkgIntKnotY=[128.0],
            greek_backend=greek, fdiff_backend="fft", solver="lu",
            fluct_dtype="float64", **mode_kw)
        fn = solve_and_subtract_fn(cfg)
        sol, diff = fn(jnp.asarray(I), jnp.asarray(J),
                       jnp.asarray(I), jnp.asarray(J))
        return np.asarray(sol), np.asarray(diff)

    s_ref, d_ref = run("fft")
    s_pw, d_pw = run("peeled")
    assert np.abs(s_pw - s_ref).max() / np.abs(s_ref).max() < 1e-6
    assert np.abs(d_pw - d_ref).max() / np.abs(d_ref).max() < 1e-6
