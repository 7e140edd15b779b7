"""v2 engine features: B-spline bases, separate scaling modes, regularization."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.config import SFFTConfig, BasisSpec
from sfft_jax.core.engine import ElementalSFFT
from sfft_jax.core.basis import basis_planes, basis_1d_tables

from oracle import basis_planes_np, ab_offsets, poly_exponents

import jax.numpy as jnp


def make_pair(rng, N0=40, N1=36):
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    I = 50.0 + 0.1 * xx + 0.2 * yy
    for _ in range(14):
        x0, y0 = rng.uniform(3, N0 - 3), rng.uniform(3, N1 - 3)
        I = I + rng.uniform(50, 400) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * rng.uniform(0.8, 1.4) ** 2)
        )
    J = (1.0 + 0.1 * xx / N0) * I + 2.0 + rng.normal(0, 0.5, I.shape)
    I = I + rng.normal(0, 0.5, I.shape)
    return I, J


def general_design_matrix(I, cfg):
    """Dense spatial-domain design matrix for ANY config (incl. separate
    scaling): independent oracle for the generalized engine."""
    import jax

    N0, N1 = I.shape
    SCALE = 1.0 / (N0 * N1)
    Bk = np.asarray(basis_planes(cfg.kernel_basis, N0, N1, dtype=jnp.float64))
    Tq = np.asarray(basis_planes(cfg.bg_basis, N0, N1, dtype=jnp.float64))
    if cfg.scaling_mode == "ENTANGLED":
        Bs = Bk
    else:
        Bs = np.asarray(basis_planes(cfg.scaling_basis, N0, N1, dtype=jnp.float64))
        if Bs.shape[0] < cfg.Fij:
            Bs = np.concatenate([Bs, np.zeros((cfg.Fij - Bs.shape[0], N0, N1))])
    cols = []
    for k in range(cfg.Fij):
        SIk = Bk[k] * I
        SSk = Bs[k] * I
        for (a, b) in ab_offsets(cfg.w0, cfg.w1):
            if a == 0 and b == 0:
                cols.append(SCALE * SSk)
            else:
                cols.append(SCALE * (np.roll(SIk, (a, b), axis=(0, 1)) - SIk))
    for T in Tq:
        cols.append(T)
    return np.stack([c.ravel() for c in cols], axis=1)


def oracle_solve_general(I, J, cfg):
    """Constrained LSQ oracle honoring the scaling-mode tweak."""
    X = general_design_matrix(I, cfg)
    NEQ = X.shape[1]
    ij00 = np.arange(cfg.center_ab, cfg.Fijab, cfg.Fab)
    mode = cfg.scaling_mode
    if mode == "ENTANGLED":
        drop = ij00[1:] if cfg.const_phot_ratio else []
        keep = np.setdiff1d(np.arange(NEQ), drop)
        Xk = X[:, keep]
        sol_k = np.linalg.solve(Xk.T @ Xk, Xk.T @ J.ravel())
        sol = np.zeros(NEQ)
        sol[keep] = sol_k
        return sol
    if mode == "SEPARATE-CONSTANT":
        if cfg.kernel_basis.kind == "polynomial":
            keep = np.setdiff1d(np.arange(NEQ), ij00[1:])
            Xk = X[:, keep]
            sol_k = np.linalg.solve(Xk.T @ Xk, Xk.T @ J.ravel())
            sol = np.zeros(NEQ)
            sol[keep] = sol_k
            return sol
        # bspline: all center dofs equal -> aggregate column
        keep = np.setdiff1d(np.arange(NEQ), ij00)
        Xagg = X[:, ij00].sum(axis=1, keepdims=True)
        Xk = np.concatenate([X[:, keep], Xagg], axis=1)
        sol_k = np.linalg.solve(Xk.T @ Xk, Xk.T @ J.ravel())
        sol = np.zeros(NEQ)
        sol[keep] = sol_k[:-1]
        sol[ij00] = sol_k[-1]
        return sol
    # SEPARATE-VARYING: drop zero-padded placeholder dofs
    drop = ij00[cfg.ScaFij :]
    keep = np.setdiff1d(np.arange(NEQ), drop)
    Xk = X[:, keep]
    sol_k = np.linalg.solve(Xk.T @ Xk, Xk.T @ J.ravel())
    sol = np.zeros(NEQ)
    sol[keep] = sol_k
    return sol


def check_vs_oracle(rng, cfg, rtol=3e-5):
    I, J = make_pair(rng, cfg.N0, cfg.N1)
    sol, diff = ElementalSFFT.ESS(I, J, cfg, Subtract=True)
    sol = np.asarray(sol)
    sol_o = oracle_solve_general(I, J, cfg)
    scale = np.abs(sol_o).max()
    assert np.allclose(sol, sol_o, rtol=rtol, atol=rtol * scale), (
        f"max dev {np.abs(sol - sol_o).max():.3e} vs scale {scale:.3e}"
    )
    X = general_design_matrix(I, cfg)
    diff_o = J - (X @ sol_o).reshape(I.shape)
    assert np.allclose(np.asarray(diff), diff_o, atol=1e-6 * np.abs(J).max())


def test_separate_constant_poly_equals_v1_cpr(rng):
    I, J = make_pair(rng)
    cfg_v1 = SFFTConfig(N0=40, N1=36, w0=1, w1=1, const_phot_ratio=True)
    cfg_v2 = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        scaling_basis=BasisSpec("polynomial", 0),
    )
    s1, _ = ElementalSFFT.ESS(I, J, cfg_v1)
    s2, _ = ElementalSFFT.ESS(I, J, cfg_v2)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-10)


def test_separate_varying_poly(rng):
    cfg = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        kernel_basis=BasisSpec("polynomial", 2),
        scaling_basis=BasisSpec("polynomial", 1),
    )
    check_vs_oracle(rng, cfg)


def test_bspline_kernel_entangled(rng):
    cfg = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        kernel_basis=BasisSpec("bspline", 2, (20.0,), (18.0,)),
        bg_basis=BasisSpec("polynomial", 1),
        const_phot_ratio=False,
    )
    check_vs_oracle(rng, cfg)


def test_bspline_kernel_separate_constant_aggregate(rng):
    cfg = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        kernel_basis=BasisSpec("bspline", 2, (20.0,), (18.0,)),
        bg_basis=BasisSpec("polynomial", 1),
        scaling_basis=BasisSpec("polynomial", 0),
    )
    check_vs_oracle(rng, cfg)


def test_bspline_everything_separate_varying(rng):
    cfg = SFFTConfig(
        N0=40, N1=36, w0=1, w1=1,
        kernel_basis=BasisSpec("bspline", 2, (20.0,), (18.0,)),
        bg_basis=BasisSpec("bspline", 1, (20.0,), ()),
        scaling_basis=BasisSpec("bspline", 1, (), ()),
    )
    check_vs_oracle(rng, cfg)


def test_bspline_partition_of_unity():
    U, V = basis_1d_tables(BasisSpec("bspline", 3, (10.0, 25.0), (15.0,)), 40, 36)
    np.testing.assert_allclose(U.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(V.sum(axis=1), 1.0, atol=1e-12)


def test_regularization_quadratic_form(rng):
    """v^T REGMAT v must equal SCALE^2 * mean_q ||LAP @ Kstd(x_q)||^2 computed
    independently via realized kernels."""
    from sfft_jax.core.regularize import apply_regularization, _iregmat
    from sfft_jax.post.solution import sfft2standard

    N0 = N1 = 32
    xy = tuple((float(x), float(y)) for x, y in
               rng.uniform(2, 30, size=(16, 2)))
    cfg = SFFTConfig(
        N0=N0, N1=N1, w0=2, w1=2,
        kernel_basis=BasisSpec("polynomial", 2),
        regularize_lambda=1.0, reg_xy=xy, ignore_laplacian_kercent=False,
    )
    lhs0 = jnp.zeros((cfg.NEQ, cfg.NEQ), jnp.float64)
    REG = np.asarray(apply_regularization(cfg, lhs0))

    v = rng.normal(size=cfg.NEQ)
    v[cfg.Fijab:] = 0.0
    quad = v @ REG @ v

    # independent: realize delta-basis kernel coeffs at each point, convert to
    # standard basis, apply the Laplacian stencil, sum squares
    from sfft_jax.core.basis import basis_at_points

    a = v[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1)
    sx = np.array([p[0] for p in xy]) / N0
    sy = np.array([p[1] for p in xy]) / N1
    B = basis_at_points(cfg.kernel_basis, N0, N1, sx, sy)  # (Fij, NQ)
    acc = 0.0
    L0, L1 = cfg.L0, cfg.L1
    RR, CC = np.mgrid[0:L0, 0:L1]
    rr, cc = RR.ravel(), CC.ravel()
    lap = np.zeros((cfg.Fab, cfg.Fab))
    nbr = (np.abs(rr[:, None] - rr[None, :]) + np.abs(cc[:, None] - cc[None, :])) == 1
    lap[nbr] = -1
    np.fill_diagonal(lap, nbr.sum(axis=1))
    for q in range(len(sx)):
        kq = np.tensordot(B[:, q], a, axes=(0, 0))          # delta basis coeffs
        kstd = sfft2standard(kq[None], cfg.w0, cfg.w1)[0]   # standard basis
        acc += np.sum((lap @ kstd.ravel()) ** 2)
    # the reference's iREGMAT stores LTL[r,c] + LTL[c,r], i.e. the HESSIAN
    # (2x the energy) of ||LAP Kstd||^2 — keep that convention for parity
    expected = 2.0 * cfg.SCALE**2 * acc / len(sx)
    np.testing.assert_allclose(quad, expected, rtol=1e-8)


def test_regularization_smooths_kernel(rng):
    """Larger lambda must monotonically reduce the penalized quantity (the
    REGMAT quadratic form of the solved coefficients)."""
    from sfft_jax.core.regularize import apply_regularization

    I, J = make_pair(rng)
    xy = tuple((float(x), float(y)) for x, y in
               np.array([[10.0, 10.0], [30.0, 10.0], [10.0, 26.0], [30.0, 26.0]]))
    base = dict(N0=40, N1=36, w0=2, w1=2,
                kernel_basis=BasisSpec("polynomial", 1), reg_xy=xy)

    def penalty(lam):
        cfg = SFFTConfig(**base, regularize_lambda=lam)
        sol, _ = ElementalSFFT.ESS(I, J, cfg)
        cfg_unit = SFFTConfig(**base, regularize_lambda=1.0)
        REG = np.asarray(apply_regularization(
            cfg_unit, jnp.zeros((cfg.NEQ, cfg.NEQ), jnp.float64)))
        v = np.asarray(sol)
        return v @ REG @ v

    e0, e1, e2 = penalty(0.0), penalty(1e3), penalty(1e8)
    assert e1 <= e0 * (1 + 1e-9)
    assert e2 < e1
    assert e2 < 1e-3 * max(e0, 1e-30)


def test_regularization_streamed_equals_dense(rng):
    """assemble_system(reg_terms=...) must equal the standalone dense
    apply_regularization on the assembled system — incl. SEPARATE-VARYING's
    four-way center-offset case split. (The streamed form exists because the
    dense REGMAT add needs (Fijab, Fijab)-scale temporaries at 13k dof.)"""
    from sfft_jax.core.assemble import assemble_system, entangled_tables, GreekTables
    from sfft_jax.core.engine import _solve_impl  # noqa: F401 (import parity)
    from sfft_jax.core.greek import greek_tables, greek_tables_separate
    from sfft_jax.core.regularize import apply_regularization, regularization_terms
    from sfft_jax.core.engine import _plane_stacks

    I, J = make_pair(rng)
    xy = tuple((float(x), float(y)) for x, y in rng.uniform(3, 30, size=(12, 2)))
    for mode_kw in (
        dict(),  # ENTANGLED
        dict(scaling_basis=BasisSpec("polynomial", 1)),
    ):
        cfg = SFFTConfig(
            N0=40, N1=36, w0=2, w1=2,
            kernel_basis=BasisSpec("polynomial", 1),
            bg_basis=BasisSpec("polynomial", 1),
            regularize_lambda=7.5, reg_xy=xy, **mode_kw)
        s = cfg.SCALE
        SI, ST, SSc = _plane_stacks(cfg, jnp.asarray(I))
        Comg, Cgam, Cthe, Cphi, Cdel = greek_tables(
            SI, ST, jnp.asarray(J), cfg.w0, cfg.w1, backend="fft",
            bg_spec=cfg.bg_basis)
        tables = entangled_tables(
            cfg, (s**3) * Comg, (s**2) * Cgam, (s**2) * Cthe, s * Cphi, s * Cdel)
        if cfg.scaling_mode == "SEPARATE-VARYING":
            Pbs, Pss, Pgs, Pts = greek_tables_separate(
                SI, SSc, ST, jnp.asarray(J), cfg.w0, cfg.w1, backend="fft",
                bg_spec=cfg.bg_basis, n_active=cfg.scaling_basis.num_funcs())
            tables = GreekTables(
                Pbb=tables.Pbb, Pbs=(s**3) * Pbs, Pss=(s**3) * Pss,
                Pgb=tables.Pgb, Pgs=(s**2) * Pgs,
                Ptb=tables.Ptb, Pts=(s**2) * Pts,
                Pphi=tables.Pphi, Pdel=tables.Pdel)
        lhs_dense, rhs_dense = assemble_system(cfg, tables)
        lhs_dense = np.asarray(apply_regularization(cfg, lhs_dense))
        lhs_str, rhs_str = assemble_system(
            cfg, tables, reg_terms=regularization_terms(cfg))
        scale = np.max(np.abs(lhs_dense))
        np.testing.assert_allclose(np.asarray(lhs_str), lhs_dense,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(np.asarray(rhs_str), np.asarray(rhs_dense))


def test_random_config_sweep_vs_oracle():
    """Randomized cross-product of engine dimensions vs the dense-LSQ oracle:
    kernel/background basis kind+degree+knots, all three scaling modes,
    const_phot_ratio, asymmetric kernel half-widths, non-square images.
    Seeded, 8 draws — a combinatorial net under the targeted tests."""
    rng = np.random.default_rng(2026)
    for draw in range(8):
        N0 = int(rng.integers(28, 44))
        N1 = int(rng.integers(24, 40))
        w0 = int(rng.integers(1, 3))
        w1 = int(rng.integers(1, 3))

        def rand_basis(max_funcs=None):
            if rng.random() < 0.5:
                return BasisSpec("polynomial", int(rng.integers(0, 3)))
            deg = int(rng.integers(1, 3))
            kx = sorted(rng.uniform(6, N0 - 6, rng.integers(0, 2)))
            ky = sorted(rng.uniform(6, N1 - 6, rng.integers(0, 2)))
            return BasisSpec("bspline", deg, tuple(kx), tuple(ky))

        kb = rand_basis()
        bb = rand_basis()
        mode = rng.choice(["ENTANGLED", "SEPARATE-CONSTANT",
                           "SEPARATE-VARYING"])
        sb = None
        cpr = bool(rng.random() < 0.5)
        if mode == "SEPARATE-CONSTANT":
            sb = BasisSpec("polynomial", 0)
        elif mode == "SEPARATE-VARYING":
            sb = BasisSpec("polynomial", 1)
            if kb.num_funcs() < sb.num_funcs():
                kb = BasisSpec("polynomial", 2)
        cfg = SFFTConfig(N0=N0, N1=N1, w0=w0, w1=w1, kernel_basis=kb,
                         bg_basis=bb, scaling_basis=sb, const_phot_ratio=cpr)
        assert cfg.scaling_mode == mode
        check_vs_oracle(np.random.default_rng(1000 + draw), cfg)
