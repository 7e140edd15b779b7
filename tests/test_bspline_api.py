"""BSpline packet API: config construction, FITS round trip, kernel realization."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.api.bspline import (
    BSplineMatchingKernel,
    BSplinePacket,
    make_bspline_config,
    write_bspline_solution_fits,
)
from sfft_jax.config import BasisSpec, SFFTConfig
from sfft_jax.core.engine import ElementalSFFT
from sfft_jax.io import fits
from sfft_jax.post.solution import RealizeMatchingKernel

from test_v2_engine import make_pair


def test_make_bspline_config_modes():
    cfg = make_bspline_config(64, 64, 4, SEPARATE_SCALING=False)
    assert cfg.scaling_mode == "ENTANGLED"
    cfg = make_bspline_config(64, 64, 4, SEPARATE_SCALING=True, ScaSpDegree=0)
    assert cfg.scaling_mode == "SEPARATE-CONSTANT"
    cfg = make_bspline_config(
        64, 64, 4, KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[32.0], KerIntKnotY=[32.0],
        SEPARATE_SCALING=True, ScaSpDegree=1,
    )
    assert cfg.scaling_mode == "SEPARATE-VARYING"
    assert cfg.Fij == 16 and cfg.ScaFij == 3
    with pytest.raises(ValueError):
        make_bspline_config(64, 64, 4, KerSpDegree=1, SEPARATE_SCALING=True,
                            ScaSpDegree=3)


def test_matching_kernel_consistency_entangled(rng):
    """Generalized realizer must agree with the v1 polynomial realizer."""
    I, J = make_pair(rng)
    cfg = SFFTConfig(N0=40, N1=36, w0=1, w1=1, const_phot_ratio=False)
    sol, _ = ElementalSFFT.ESS(I, J, cfg)
    sol = np.asarray(sol)
    q = np.array([[17.0, 22.0], [5.0, 30.0]])
    k1 = RealizeMatchingKernel(q).from_solution(sol, cfg)
    k2 = BSplineMatchingKernel(q).from_solution(sol, cfg)
    np.testing.assert_allclose(k1, k2, rtol=1e-12)


def test_matching_kernel_separate_varying_sums(rng):
    """For SEPARATE-VARYING, the realized kernel sum at any point must equal
    the scaling basis expansion of the a00 dofs."""
    from sfft_jax.core.basis import basis_at_points

    I, J = make_pair(rng)
    cfg = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        kernel_basis=BasisSpec("polynomial", 2),
        scaling_basis=BasisSpec("polynomial", 1),
    )
    sol, _ = ElementalSFFT.ESS(I, J, cfg)
    sol = np.asarray(sol)
    q = np.array([[10.0, 9.0], [35.0, 30.0]])
    kers = BSplineMatchingKernel(q).from_solution(sol, cfg)
    ac = sol[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1) / (cfg.N0 * cfg.N1)
    Bs = basis_at_points(cfg.scaling_basis, cfg.N0, cfg.N1,
                         q[:, 0] / cfg.N0, q[:, 1] / cfg.N1)
    expected = np.tensordot(Bs.T, ac[: Bs.shape[0], cfg.w0, cfg.w1], (1, 0))
    np.testing.assert_allclose(kers.sum(axis=(1, 2)), expected, rtol=1e-9)


def test_bsp_fits_end_to_end(tmp_path, rng):
    I, J = make_pair(rng)
    for name, arr in [("ref", I), ("sci", J)]:
        fits.write(str(tmp_path / f"{name}.fits"), arr.T)
    sol, diff = BSplinePacket.BSP(
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        FITS_DIFF=str(tmp_path / "diff.fits"),
        FITS_Solution=str(tmp_path / "sol.fits"),
        ForceConv="REF", GKerHW=1,
        KerSpType="B-Spline", KerSpDegree=2, KerIntKnotX=[20.0], KerIntKnotY=[18.0],
        SEPARATE_SCALING=True, ScaSpDegree=0,
        BkgSpType="Polynomial", BkgSpDegree=1,
    )
    assert np.isfinite(diff).all()
    assert np.sqrt(np.mean(diff**2)) < np.sqrt(np.mean((J - I) ** 2))
    out, hdr = fits.read(str(tmp_path / "sol.fits"))
    assert out.size == len(sol)
    assert hdr["KSPTYPE"] == "bspline"


def test_v2_solution_fits_roundtrip(tmp_path, rng):
    """write_bspline_solution_fits -> read_bspline_solution_fits must restore
    the FULL v2 config (kernel/background/scaling bases incl. internal knots)
    and from_fits must realize identical kernels — the checkpoint/resume
    reader for generalized configs (reference BSpline_MatchingKernel.FromFITS,
    sfft/BSplineSFFT.py:4557-4650)."""
    from sfft_jax.api.bspline import read_bspline_solution_fits

    I, J = make_pair(rng)
    cfg = make_bspline_config(
        40, 36, 1,
        KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[20.0], KerIntKnotY=[14.0, 24.0],
        SEPARATE_SCALING=True, ScaSpType="B-Spline", ScaSpDegree=1,
        ScaIntKnotX=[20.0], ScaIntKnotY=[18.0],
        BkgSpType="B-Spline", BkgSpDegree=2,
        BkgIntKnotX=[20.0], BkgIntKnotY=[18.0],
    )
    sol, _ = ElementalSFFT.ESS(I, J, cfg)
    sol = np.asarray(sol)
    path = str(tmp_path / "sol_v2.fits")
    write_bspline_solution_fits(path, sol, cfg)
    sol2, cfg2 = read_bspline_solution_fits(path)
    assert cfg2.kernel_basis == cfg.kernel_basis
    assert cfg2.bg_basis == cfg.bg_basis
    assert cfg2.scaling_basis == cfg.scaling_basis
    assert (cfg2.N0, cfg2.N1, cfg2.w0, cfg2.w1) == (cfg.N0, cfg.N1, cfg.w0, cfg.w1)
    assert cfg2.scaling_mode == cfg.scaling_mode
    np.testing.assert_array_equal(sol2, sol)
    q = np.array([[10.0, 9.0], [35.0, 30.0]])
    np.testing.assert_allclose(
        BSplineMatchingKernel(q).from_fits(path),
        BSplineMatchingKernel(q).from_solution(sol, cfg), rtol=1e-12)


def test_bsp_with_regularization(tmp_path, rng):
    I, J = make_pair(rng)
    for name, arr in [("ref", I), ("sci", J)]:
        fits.write(str(tmp_path / f"{name}.fits"), arr.T)
    xy = np.array([[10.0, 10.0], [30.0, 26.0]])
    sol, diff = BSplinePacket.BSP(
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        ForceConv="REF", GKerHW=2,
        REGULARIZE_KERNEL=True, XY_REGULARIZE=xy, LAMBDA_REGULARIZE=1e-5,
    )
    assert np.isfinite(diff).all()
