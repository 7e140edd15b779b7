"""Engine correctness vs the independent dense-LSQ oracle + property tests."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401  (enables x64)
from sfft_jax.config import SFFTConfig, BasisSpec
from sfft_jax.core.engine import ElementalSFFT, GeneralSFFT

from oracle import solve_oracle, model_image, design_matrix


def make_pair(rng, N0=24, N1=20, nsrc=12):
    """Synthetic I with gaussian sources + smooth bg; J = shifted/blurred-ish."""
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    I = 10.0 + 0.01 * xx + 0.02 * yy
    for _ in range(nsrc):
        x0, y0 = rng.uniform(2, N0 - 2), rng.uniform(2, N1 - 2)
        amp = rng.uniform(50, 300)
        sig = rng.uniform(0.8, 1.6)
        I = I + amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    J = np.roll(I, (0, 0), axis=(0, 1)) * 1.12 + 3.0
    J = J + rng.normal(0, 0.8, size=I.shape)
    I = I + rng.normal(0, 0.5, size=I.shape)
    return I, J


def base_cfg(N0=24, N1=20, w=1, DK=2, DB=2, cpr=True, **kw):
    defaults = dict(
        N0=N0, N1=N1, w0=w, w1=w,
        kernel_basis=BasisSpec("polynomial", DK),
        bg_basis=BasisSpec("polynomial", DB),
        const_phot_ratio=cpr,
    )
    defaults.update(kw)
    return SFFTConfig(**defaults)


@pytest.mark.parametrize("cpr", [True, False])
@pytest.mark.parametrize("w", [1, 2])
def test_solution_matches_oracle(rng, cpr, w):
    I, J = make_pair(rng)
    cfg = base_cfg(w=w, cpr=cpr)
    sol, _ = ElementalSFFT.ESS(I, J, cfg)
    sol = np.asarray(sol)
    sol_o = solve_oracle(I, J, w, w, 2, 2, const_phot_ratio=cpr)
    assert np.allclose(sol, sol_o, rtol=1e-7, atol=1e-9 * np.abs(sol_o).max())


@pytest.mark.parametrize("DK,DB", [(0, 0), (1, 2), (2, 1), (3, 3)])
def test_poly_orders(rng, DK, DB):
    I, J = make_pair(rng)
    cfg = base_cfg(DK=DK, DB=DB)
    sol, diff = ElementalSFFT.ESS(I, J, cfg, Subtract=True)
    sol_o = solve_oracle(I, J, 1, 1, DK, DB, const_phot_ratio=True)
    assert np.allclose(np.asarray(sol), sol_o, rtol=1e-6, atol=1e-8 * np.abs(sol_o).max())
    diff_o = J - model_image(I, sol_o, 1, 1, DK, DB)
    assert np.allclose(np.asarray(diff), diff_o, atol=1e-8 * np.abs(J).max())


def test_diff_matches_oracle_model(rng):
    I, J = make_pair(rng)
    cfg = base_cfg()
    sol, diff = ElementalSFFT.ESS(I, J, cfg, Subtract=True)
    diff_o = J - model_image(I, np.asarray(sol), 1, 1, 2, 2)
    assert np.allclose(np.asarray(diff), diff_o, atol=1e-9 * np.abs(J).max())


def test_exact_recovery_zero_residual(rng):
    """J built exactly from the model => DIFF ~ 0 and coefficients recovered."""
    I, _ = make_pair(rng)
    N0, N1, w = I.shape[0], I.shape[1], 1
    X = design_matrix(I, N0, N1, w, w, 2, 2)
    neq = X.shape[1]
    coeffs = np.zeros(neq)
    rng2 = np.random.default_rng(7)
    coeffs[:] = rng2.normal(0, 1.0, neq)
    # respect ConstPhotRatio: zero the forbidden kernel-sum dofs
    from oracle import stripe_free_indices

    keep = stripe_free_indices(w, w, 2, 2)
    mask = np.zeros(neq, dtype=bool)
    mask[keep] = True
    coeffs[~mask] = 0.0
    J = (X @ coeffs).reshape(N0, N1)

    cfg = base_cfg()
    sol, diff = ElementalSFFT.ESS(I, J, cfg, Subtract=True)
    assert np.allclose(np.asarray(sol), coeffs, rtol=1e-6, atol=1e-8)
    assert np.abs(np.asarray(diff)).max() < 1e-8 * np.abs(J).max()


def test_backend_consistency(rng):
    """fft vs corr greek backends and fft vs conv fdiff backends agree."""
    I, J = make_pair(rng)
    cfg_fft = base_cfg(greek_backend="fft", fdiff_backend="fft")
    cfg_corr = base_cfg(greek_backend="corr", fdiff_backend="conv")
    sol1, d1 = ElementalSFFT.ESS(I, J, cfg_fft, Subtract=True)
    sol2, d2 = ElementalSFFT.ESS(I, J, cfg_corr, Subtract=True)
    # both backends solve the same system up to f64 roundoff; conditioning
    # amplifies the table differences into ~1e-8 relative solution changes
    s1, s2 = np.asarray(sol1), np.asarray(sol2)
    assert np.allclose(s1, s2, rtol=1e-5, atol=1e-6 * np.abs(s1).max())
    d1a, d2a = np.asarray(d1), np.asarray(d2)
    assert np.allclose(d1a, d2a, atol=1e-7 * np.abs(d1a).max())


def test_greek_chunking(rng):
    I, J = make_pair(rng)
    sol1, _ = ElementalSFFT.ESS(I, J, base_cfg())
    sol2, _ = ElementalSFFT.ESS(I, J, base_cfg(greek_chunk=5))
    assert np.allclose(np.asarray(sol1), np.asarray(sol2), rtol=1e-12)


@pytest.mark.parametrize("solver", ["lu", "cho", "host", "blocked_cho",
                                    "refined", "transformed"])
def test_solvers_agree(rng, solver):
    I, J = make_pair(rng)
    sol, _ = ElementalSFFT.ESS(I, J, base_cfg(solver=solver))
    sol_ref, _ = ElementalSFFT.ESS(I, J, base_cfg(solver="lu"))
    assert np.allclose(np.asarray(sol), np.asarray(sol_ref), rtol=1e-6, atol=1e-8)


def test_refined_solve_f64_reaches_f64_floor():
    """Large-NEQ contract solver (f32 Cholesky factor + exact-f64-residual
    refinement, core/solve.py:_refined_solve_f64) must hit the f64 floor on
    an SPD system at the NIRCam-like conditioning (cond ~1e7, as on the
    real 13,226-dof system)."""
    import jax.numpy as jnp
    from sfft_jax.core.solve import _refined_solve_f64

    rng = np.random.default_rng(414)
    n = 384
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, -7, n)           # cond 1e7 after equilibration
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    x_true = rng.normal(size=n)
    b = A @ x_true
    x = np.asarray(_refined_solve_f64(jnp.asarray(A), jnp.asarray(b)))
    # f64-grade: far below anything an f32 solve could reach (~cond*eps32
    # ~ 0.6 relative); direct f64 reference for the error scale
    x_ref = np.linalg.solve(A, b)
    err = np.max(np.abs(x - x_ref)) / np.max(np.abs(x_ref))
    assert err < 1e-9, err


def test_general_subtract_with_masks(rng):
    I, J = make_pair(rng)
    mI, mJ = I.copy(), J.copy()
    mI[5:8, 5:8] = 0.0
    mJ[5:8, 5:8] = 0.0
    sol, diff, contam = GeneralSFFT.GSS(I, J, mI, mJ, base_cfg(), ContamMask_I=None)
    sol_o = solve_oracle(mI, mJ, 1, 1, 2, 2, const_phot_ratio=True)
    assert np.allclose(np.asarray(sol), sol_o, rtol=1e-6, atol=1e-8 * np.abs(sol_o).max())
    diff_o = J - model_image(I, sol_o, 1, 1, 2, 2)
    assert np.allclose(np.asarray(diff), diff_o, atol=1e-8 * np.abs(J).max())
    assert contam is None


def test_contam_mask_propagation(rng):
    I, J = make_pair(rng)
    contam = np.zeros(I.shape, dtype=bool)
    contam[10:13, 10:13] = True
    _, _, contam_out = GeneralSFFT.GSS(I, J, I, J, base_cfg(), ContamMask_I=contam)
    contam_out = np.asarray(contam_out)
    # propagated mask must cover the original contaminated pixels' neighborhood
    assert contam_out.shape == I.shape
    assert contam_out.sum() >= contam.sum()


def test_forceconv_sci_sign_and_nan(rng):
    """ForceConv='SCI' swaps the roles (convolve SCI to match REF) and negates
    the difference so D stays SCI-minus-model oriented: PCP(A, B, 'SCI') must
    equal -PCP(B, A, 'REF') exactly, and NaN pixels of either input must come
    back NaN in the difference (reference CustomizedPacket.py ForceConv
    handling + NaN union semantics)."""
    from sfft_jax.api.customized import PureJAXCustomizedPacket as P

    A, B = make_pair(rng)
    mA, mB = A.copy(), B.copy()
    A = A.copy()
    A[3, 4] = np.nan  # masked inputs stay clean; unmasked carry a NaN
    sol_sci, diff_sci = P.PCP(A, B, mA, mB, "SCI", 1)
    sol_ref, diff_ref = P.PCP(B, A, mB, mA, "REF", 1)
    np.testing.assert_array_equal(np.asarray(sol_sci), np.asarray(sol_ref))
    d1, d2 = np.asarray(diff_sci), np.asarray(diff_ref)
    assert np.isnan(d1[3, 4]) and np.isnan(d2[3, 4])
    mask = ~np.isnan(d1)
    np.testing.assert_array_equal(np.isnan(d1), np.isnan(d2))
    np.testing.assert_allclose(d1[mask], -d2[mask], rtol=0, atol=0)


def test_gss_same_pair_fused_path_matches_two_program_path(rng):
    """GSS with PixA_I is PixA_mI (masked == unmasked, same objects) takes
    the fused same-pair jit (shared plane spectra in the exact backends);
    it must return exactly what the generic two-program path returns for
    equal-valued but distinct arrays."""
    from sfft_jax.core.engine import GeneralSFFT

    I, J = make_pair(rng, N0=48, N1=48)
    cfg = base_cfg(N0=48, N1=48, w=1)
    sol_fused, diff_fused, contam = GeneralSFFT.GSS(I, J, I, J, cfg)
    assert contam is None
    sol_ref, diff_ref, _ = GeneralSFFT.GSS(I, J, I.copy(), J.copy(), cfg)
    np.testing.assert_allclose(np.asarray(sol_fused), np.asarray(sol_ref),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(diff_fused), np.asarray(diff_ref),
                               rtol=1e-9, atol=1e-11)


def test_mode_resolution_and_balanced_backend(rng):
    """config.MODES named modes resolve the same knobs on every backend; the
    retired 'balanced' mode and an unknown mode raise; and the exact-greek +
    exact-solve + fft32-fdiff triple runs with a contract-grade solution
    and an fft32-floor difference."""
    from sfft_jax.config import make_config, MODES

    assert set(MODES) == {"contract", "fast"}
    cfg = make_config(24, 20, 1, mode="contract")
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == \
        ("fft", "fft", "lu")
    for mode in ("balanced", "speedy"):
        with pytest.raises(ValueError):
            make_config(24, 20, 1, mode=mode)

    I, J = make_pair(rng)
    cfg_bal = base_cfg(greek_backend="exact", fdiff_backend="fft32",
                       solver="exact")
    cfg_ref = base_cfg(greek_backend="fft", fdiff_backend="fft", solver="lu")
    sol_b, d_b = ElementalSFFT.ESS(I, J, cfg_bal, Subtract=True)
    sol_r, d_r = ElementalSFFT.ESS(I, J, cfg_ref, Subtract=True)
    s_b, s_r = np.asarray(sol_b), np.asarray(sol_r)
    # solution: exact tables + exact solve = contract grade
    assert np.allclose(s_b, s_r, rtol=1e-6, atol=1e-8 * np.abs(s_r).max())
    # difference: fft32 construction floor (~1e-4 relative)
    d_ba, d_ra = np.asarray(d_b), np.asarray(d_r)
    assert np.allclose(d_ba, d_ra, atol=5e-4 * np.abs(d_ra).max())


@pytest.mark.parametrize("cpr,DK,DB", [(True, 2, 2), (False, 2, 2),
                                       (True, 3, 1), (True, 1, 0)])
def test_transformed_solver_constraint_and_degrees(rng, cpr, DK, DB):
    """The Legendre-congruence solver (core/solve.py:_transformed_solve) must
    reproduce the reduced-system LU solution exactly-in-band across kernel/
    background degrees, honoring the ConstPhotRatio stripe constraint inside
    the transform (removed dofs exactly zero)."""
    I, J = make_pair(rng)
    sol_t, d_t = ElementalSFFT.ESS(
        I, J, base_cfg(DK=DK, DB=DB, cpr=cpr, solver="transformed"),
        Subtract=True)
    sol_r, d_r = ElementalSFFT.ESS(
        I, J, base_cfg(DK=DK, DB=DB, cpr=cpr, solver="lu"), Subtract=True)
    st, sr = np.asarray(sol_t), np.asarray(sol_r)
    # band: two f64 solvers differ by ~cond*eps64 (DK=3 reaches cond ~5e7
    # on this tiny pair; 'cho' vs 'lu' shows the same ~6e-10 spread)
    assert np.allclose(st, sr, rtol=1e-6, atol=1e-8 * np.abs(sr).max())
    if cpr:
        from sfft_jax.core.indices import kernel_sum_dof_index
        from sfft_jax.config import make_config
        cfg = base_cfg(DK=DK, DB=DB, cpr=cpr)
        rem = kernel_sum_dof_index(cfg)[1:]
        assert np.all(st[rem] == 0.0)
    assert np.allclose(np.asarray(d_t), np.asarray(d_r),
                       atol=1e-8 * np.abs(np.asarray(d_r)).max())


def test_transformed_solver_certified_fallback():
    """When the f32-factor refinement cannot converge (cond*eps32 >> 1 —
    synthetic cond ~3e11 system), the residual certificate must route the
    solve through the unconditional exact fallback and still return an
    f64-grade solution."""
    import jax.numpy as jnp
    from sfft_jax.config import make_config
    from sfft_jax.core.indices import kernel_sum_dof_index
    from sfft_jax.core.solve import _transformed_solve, _tweak_plan

    cfg = make_config(24, 20, 1, dtype="float64", solver="transformed")
    rng = np.random.default_rng(77)
    n = cfg.NEQ
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, -11.5, n)) @ Q.T
    A = 0.5 * (A + A.T)
    b = A @ rng.normal(size=n)
    x = np.asarray(_transformed_solve(cfg, jnp.asarray(A), jnp.asarray(b)))
    # oracle: reduced-system solve with removed dofs pinned to zero
    pres, _, _ = _tweak_plan(cfg)
    xo = np.zeros(n)
    xo[pres] = np.linalg.solve(A[np.ix_(pres, pres)], b[pres])
    rem = kernel_sum_dof_index(cfg)[1:]
    assert np.all(x[rem] == 0.0)
    rel = np.max(np.abs(x - xo)) / np.max(np.abs(xo))
    # fallback floor ~ cond * eps64 ~ 3e-5; the stalled f32 path would sit
    # at O(1) error here
    assert rel < 3e-4, rel
