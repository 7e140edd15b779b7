"""Post-processing: solution realization, CSZ kits, decorrelation, grid conv."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.config import SFFTConfig, BasisSpec
from sfft_jax.core.engine import ElementalSFFT
from sfft_jax.post.fftkits import kernel_csz, kernel_csz_inv, fft_convolve
from sfft_jax.post.solution import (
    RealizeFluxScaling,
    RealizeMatchingKernel,
    sfft2standard,
    standard2sfft,
    sfft_dict_from_solution,
)
from sfft_jax.post.grid_convolve import grid_convolve_uniform, grid_convolve_labels, make_tile_grid
from sfft_jax.utils.convolve import convolve2d


def test_csz_roundtrip():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(5, 7))
    kimg = kernel_csz(k, 32, 32)
    assert kimg.shape == (32, 32)
    k2, lost = kernel_csz_inv(kimg, 5, 7)
    np.testing.assert_allclose(k2, k, atol=1e-14)
    assert lost < 1e-12
    # center lands at (0, 0)
    assert kimg[0, 0] == k[2, 3]


def test_fft_convolve_matches_direct():
    rng = np.random.default_rng(1)
    img = rng.normal(10, 2, (40, 36))
    k = rng.normal(size=(5, 5))
    out_fft = np.asarray(fft_convolve(img, k))
    out_dir = convolve2d(img, k, boundary="fill", fill_value=0.0,
                         normalize_kernel=False, nan_treatment="fill")
    np.testing.assert_allclose(out_fft, out_dir, atol=1e-9)


def test_basis_conversions_roundtrip():
    rng = np.random.default_rng(2)
    c = rng.normal(size=(6, 5, 5))
    back = standard2sfft(sfft2standard(c, 2, 2), 2, 2)
    np.testing.assert_allclose(back, c, atol=1e-13)


def test_kernel_realization_consistency(rng):
    """The realized kernel at a point, convolved into I at that point, must
    reproduce the engine's local model (up to background)."""
    from tests.test_engine import make_pair, base_cfg

    I, J = make_pair(rng)
    cfg = base_cfg()
    sol, _ = ElementalSFFT.ESS(I, J, cfg)
    sol = np.asarray(sol)

    # flux scaling == kernel sum at the query point
    q = np.array([[12.0, 10.0]])
    ker = RealizeMatchingKernel(q).from_solution(sol, cfg)[0]
    fs = RealizeFluxScaling(q).from_solution(sol, cfg)[0]
    np.testing.assert_allclose(ker.sum(), fs, rtol=1e-10)

    d = sfft_dict_from_solution(sol, cfg)
    assert set(d.keys()) == {(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)}


def test_grid_convolve_uniform_vs_labels():
    rng = np.random.default_rng(3)
    img = rng.normal(5, 1, (64, 60))
    TiHW = 7
    AllocatedL, XY = make_tile_grid(*img.shape, TiHW)
    nseg = AllocatedL.max() + 1
    kers = rng.normal(0.2, 0.05, (nseg, 5, 5)) + 0.5
    out_u = grid_convolve_uniform(img, kers, TiHW)
    out_l = grid_convolve_labels(img, AllocatedL, kers)
    # interiors must match; tile-boundary halos differ only at image borders
    interior = (slice(8, -8), slice(8, -8))
    np.testing.assert_allclose(out_u[interior], out_l[interior], rtol=1e-5, atol=1e-7)


def test_convolve2d_nan_interpolation():
    img = np.ones((20, 20)) * 7.0
    img[10, 10] = np.nan
    k = np.ones((3, 3)) / 9.0
    out = convolve2d(img, k, boundary="extend", normalize_kernel=True)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 7.0, rtol=1e-10)


def test_grid_convolve_fft_equals_direct():
    rng = np.random.default_rng(9)
    img = rng.normal(5, 1, (64, 60))
    TiHW = 7
    nseg = (64 // 15 + 1) * (60 // 15 + 1)
    AllocatedL, _ = make_tile_grid(64, 60, TiHW)
    nseg = AllocatedL.max() + 1
    kers = rng.normal(0.2, 0.05, (nseg, 5, 5)) + 0.5
    out_d = grid_convolve_uniform(img, kers, TiHW, use_fft=False)
    out_f = grid_convolve_uniform(img, kers, TiHW, use_fft=True)
    np.testing.assert_allclose(out_f, out_d, rtol=1e-9, atol=1e-9)


def test_bdc_denominator_clipping():
    """BSplineDeCorrelation.BDC = DCC + denominator clipping at
    max/DENO_CLIP_RATIO (reference sfft/BSplineSFFT.py:4853-4857). With a
    near-singular denominator (a kernel whose spectrum has near-zeros) the
    unclipped whitening kernel blows up; the clipped one stays bounded, and
    with a huge ratio BDC degenerates to DCC exactly."""
    from sfft_jax.post.decorrelation import (BSplineDeCorrelation,
                                             DeCorrelationCalculator,
                                             decorrelation_kernel)

    # two-pixel averaging kernel: F = (1 + e^{-i w}) / 2 has an EXACT
    # spectral zero at Nyquist -> unclipped 1/sqrt(0) = inf -> NaN kernel
    mk = np.zeros((5, 5))
    mk[2, 2] = 0.5
    mk[2, 3] = 0.5
    kd_dcc = DeCorrelationCalculator.DCC([mk], [1.0], [mk], [1.0],
                                         MK_Fin=None, VERBOSE_LEVEL=0)
    kd_bdc = BSplineDeCorrelation.BDC([mk], [1.0], [mk], [1.0],
                                      MK_Fin=None, DENO_CLIP_RATIO=100.0,
                                      VERBOSE_LEVEL=0)
    assert not np.isfinite(kd_dcc).all()   # unclipped blows up
    assert np.isfinite(kd_bdc).all()       # clipping saves it
    # on a strictly-positive denominator a huge ratio degenerates to DCC
    mk2 = np.zeros((5, 5))
    mk2[2, 2] = 0.9
    mk2[2, 3] = 0.1
    kd2_dcc = DeCorrelationCalculator.DCC([mk2], [1.0], [mk2], [1.0],
                                          MK_Fin=None, VERBOSE_LEVEL=0)
    kd2_hi = decorrelation_kernel([mk2], [1.0], [mk2], [1.0], MK_Fin=None,
                                  VERBOSE_LEVEL=0, DENO_CLIP_RATIO=1e300)
    np.testing.assert_array_equal(kd2_hi, kd2_dcc)
    # and a small ratio genuinely reshapes the kernel
    kd2_lo = BSplineDeCorrelation.BDC([mk2], [1.0], [mk2], [1.0],
                                      MK_Fin=None, DENO_CLIP_RATIO=1.5,
                                      VERBOSE_LEVEL=0)
    assert np.max(np.abs(kd2_lo - kd2_dcc)) > 1e-6


def test_decorrelation_transfer_pcdc_semantics():
    """decorrelation_transfer = reference PCDC: Fourier map normalized to
    F[0,0] = 1, or a truncated unit-sum real kernel; REAL_OUTPUT at the same
    trivial image size must agree with decorrelation_kernel's result."""
    from sfft_jax.post.decorrelation import (decorrelation_kernel,
                                             decorrelation_transfer)

    mk = np.zeros((5, 5))
    mk[2, 2] = 0.8
    mk[1, 2] = mk[3, 2] = 0.1
    # Fourier map: normalized at DC
    fmap = decorrelation_transfer(32, 32, [mk], [1.3], [mk], [0.7],
                                  MATCH_KERNEL=mk, REAL_OUTPUT=False,
                                  NORMALIZE_OUTPUT=True, VERBOSE_LEVEL=0)
    fmap = np.asarray(fmap)
    assert fmap.shape == (32, 32)
    assert abs(fmap[0, 0] - 1.0) < 1e-12
    assert np.all(fmap > 0)
    # real output at the kernel's own trivial image size == DCC kernel
    # (decorrelation_kernel picks N0 = N1 = 2^(ceil(log2(5)) + 1) = 16)
    kd_ref = decorrelation_kernel([mk], [1.3], [mk], [0.7], MK_Fin=mk,
                                  KERatio=2.0, VERBOSE_LEVEL=0)
    kd_tr = decorrelation_transfer(16, 16, [mk], [1.3], [mk], [0.7],
                                   MATCH_KERNEL=mk, REAL_OUTPUT=True,
                                   REAL_OUTPUT_SIZE=kd_ref.shape,
                                   NORMALIZE_OUTPUT=True, VERBOSE_LEVEL=0)
    np.testing.assert_allclose(np.asarray(kd_tr), kd_ref, rtol=1e-12)
