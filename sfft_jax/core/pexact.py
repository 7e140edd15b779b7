"""Peeled + sliced exact engine — contract-grade tables at reduced slice depth.

The plain exact backend (core/exact_fft.py) runs the sliced-int8 pair-FFT on
the RAW image planes: the slicing depth (NSL_DATA=9, KMAX=8) must capture
~2^-48 of the raw plane scale because the delta-basis second differencing in
the assembly (core/assemble.py) cancels ~6 digits of the SMOOTH correlation
content — raw-scale table noise is amplified ~1e6x into the normal equations.

This module splits each image exactly, I = P_I + F_I, with P_I a low-degree
polynomial fit (core/peel.py machinery). Every Greek correlation then expands

  smooth x smooth / smooth x fluct -> exact f64 moment algebra  [no FFT]
  fluct  x fluct                   -> sliced pair-FFT windows,
                                      at a REDUCED SliceProfile

The fluctuation's slicing scales adapt to ITS OWN max, so a profile with
nsl_data = 8 captures 48 bits of the fluct scale — at worst (||F|| ~ ||I||)
exactly the plain backend's pair-representation floor, and strictly better
when the smooth fit removes mass (sky-dominated frames). The reduced profile
cuts the deep slice-dot traffic ~nsl_d*nsl_w-fold and the butterfly-stage
recombination ~#combos(kmax)-fold — the pair-FFT stage is the engine's
dominant cost.

The same decomposition pays in the difference construction (fdiff_pexact):
the spectral model sum runs on FLUCT spectra only (reduced profile), while
the smooth model — the circular convolution of polynomial planes with the
fitted kernel — is EXACT closed-form shift algebra: main term = one global
polynomial evaluation, circular wrap = per-lag correction polynomials living
on <= kernel-half-width boundary bands (the ax.S / ax.D shift matrices of
core/peel.py).

Requires polynomial kernel/background/scaling bases (like core/peel.py; the
B-spline configs stay on the plain exact backend). Replaces, for the
'pexact' backends, the reference's complex128 HadProd/FFT pipeline
(sfft/sfftcore/SFFTSubtract.py:224-383, 599-729) and Construct_FDIFF
(sfft/sfftcore/SFFTSubtract.py:771-816).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig
from sfft_jax.core.exact_fft import (CPair, SliceProfile, _intern, _two_prod,
                                     _two_sum, exact_corr_window,
                                     exact_sep_weighted_spectra,
                                     pair_from_f64,
                                     _pair_mul_static_rr, _pair_hadamard_conj,
                                     _cmatmul_sliced, exact_dft_axis)
from sfft_jax.core.indices import ref_basis_exponents
from sfft_jax.core.peel import (AxisStatic, MomentSet, axis_static,
                                fit_poly_coeffs, moment_set, poly_moment_set,
                                polycorr, shift_moment_set)


# ---------------------------------------------------------------------------
# pair helpers
# ---------------------------------------------------------------------------


def pair_sub(a: CPair, b: CPair) -> CPair:
    """Real pair minus real pair (fenced TwoSum on the hi lanes)."""
    h, e = _two_sum(a.rh, -b.rh)
    return CPair(h, a.rl - b.rl + e, None, None)


def pair_poly_plane(C: jnp.ndarray, N0: int, N1: int) -> CPair:
    """Grid evaluation of a ScaledFortranCoor polynomial as a real pair.

    C: (SP, SP) traced f64 coeffs over c0^s c1^t with c = (idx+1)/N. The
    y-contraction is a tiny exact f64 matmul (K = SP terms); the x-axis outer
    accumulation runs in fenced f32 pair arithmetic (~2^-48 of plane scale)
    and fuses into one elementwise pass without f64 grid arithmetic."""
    SP = C.shape[0]
    c0 = (np.arange(N0, dtype=np.float64) + 1.0) / N0
    c1 = (np.arange(N1, dtype=np.float64) + 1.0) / N1
    V = jnp.asarray(_intern(np.stack([c1 ** t for t in range(SP)])))
    M = jnp.einsum("st,ty->sy", C.astype(jnp.float64), V,
                   precision=lax.Precision.HIGHEST)          # (SP, N1) f64
    Mh = M.astype(jnp.float32)
    Ml = (M - Mh.astype(jnp.float64)).astype(jnp.float32)
    hi = lo = None
    for s in range(SP):
        u = c0 ** s
        uh = jnp.asarray(_intern(u.astype(np.float32)))[:, None]
        ul = jnp.asarray(_intern(
            (u - u.astype(np.float32)).astype(np.float32)))[:, None]
        p, e = _two_prod(uh, Mh[s][None, :])
        plo = e + uh * Ml[s][None, :] + ul * Mh[s][None, :]
        if hi is None:
            hi, lo = p, plo
        else:
            hi, e2 = _two_sum(hi, p)
            lo = lo + plo + e2
    return CPair(hi, lo, None, None)


# ---------------------------------------------------------------------------
# shared front end
# ---------------------------------------------------------------------------


class _Geom(NamedTuple):
    exps_k: np.ndarray       # UNION kernel(+scaling) exponents (Fij_u, 2)
    exps_b: np.ndarray
    Fk_only: int             # kernel-only count (cfg.Fij)
    SP: int                  # poly-side exponents (S_a = mu * beta_a)
    SG: int                  # moment exponents
    ax0o: AxisStatic
    ax1o: AxisStatic
    ax0g: AxisStatic
    ax1g: AxisStatic
    dmu: int


def pexact_supported(cfg: SFFTConfig) -> bool:
    if cfg.kernel_basis.kind != "polynomial" or cfg.bg_basis.kind != "polynomial":
        return False
    if (cfg.scaling_mode == "SEPARATE-VARYING"
            and cfg.scaling_basis.kind != "polynomial"):
        return False
    return True


def _geom(cfg: SFFTConfig) -> _Geom:
    if not pexact_supported(cfg):
        raise ValueError(
            "pexact backends require polynomial kernel/background/scaling "
            "bases; B-spline configs use greek_backend='exact'")
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    dmu = cfg.peel_degree
    dk = cfg.kernel_basis.degree
    ds = cfg.scaling_basis.degree if separate_varying else 0
    db = cfg.bg_basis.degree
    SP = dmu + max(dk, ds) + 1
    SG = SP + max(dk, ds, db)
    EMAX = 2 * SG + 2
    exps_k = ref_basis_exponents(cfg.kernel_basis)
    if separate_varying:
        exps_k = np.concatenate(
            [exps_k, ref_basis_exponents(cfg.scaling_basis)], axis=0)
    return _Geom(
        exps_k=exps_k, exps_b=ref_basis_exponents(cfg.bg_basis),
        Fk_only=cfg.Fij, SP=SP, SG=SG,
        ax0o=axis_static(N0, 2 * w0, SP, EMAX),
        ax1o=axis_static(N1, 2 * w1, SP, EMAX),
        ax0g=axis_static(N0, w0, SP, EMAX),
        ax1g=axis_static(N1, w1, SP, EMAX),
        dmu=dmu,
    )


class PexactShared(NamedTuple):
    """Everything the Greek tables and the exact difference both consume —
    computed ONCE per (I, J) pair (analog of greek.exact_plane_spectra)."""

    mI: jnp.ndarray          # (dmu+1, dmu+1) f64 peel coeffs of I
    mJ: jnp.ndarray
    momI_o: MomentSet        # raw-I exact moments, +-2w window, SG exponents
    momJ_g: MomentSet        # raw-J exact moments, +-w window
    sp: CPair                # stacked half spectra of [F_J] + F_I*beta_union


def pexact_plane_spectra(I: jnp.ndarray, J: jnp.ndarray,
                         cfg: SFFTConfig) -> PexactShared:
    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = jnp.dtype(cfg.dtype)
    I = I.astype(dt)
    J = J.astype(dt)
    momI_o = moment_set(I, N0, N1, 2 * w0, 2 * w1, g.SG, g.ax0o, g.ax1o)
    momJ_g = moment_set(J, N0, N1, w0, w1, g.SG, g.ax0g, g.ax1g)
    mI = fit_poly_coeffs(momI_o.M, g.dmu, g.ax0o, g.ax1o)
    mJ = fit_poly_coeffs(momJ_g.M, g.dmu, g.ax0g, g.ax1g)
    # exact-pair fluctuations: F = pair(I) - pair-eval(P). The grid eval and
    # the moment algebra use the SAME coeffs; the 2^-48*||P|| eval rounding is
    # the only smooth/fluct inconsistency and lands at 2^-48*||I||*||F|| in
    # the tables — at or below the plain exact backend's own pair floor.
    FIp = pair_sub(pair_from_f64(I), pair_poly_plane(mI, N0, N1))
    FJp = pair_sub(pair_from_f64(J), pair_poly_plane(mJ, N0, N1))
    prof = SliceProfile(*cfg.pexact_prof)
    # axis-1-deduped separable-weight pair-FFT: 7 -> 4 axis-1 legs at the
    # degree-2 config (exact_fft.exact_sep_weighted_spectra)
    c0 = (np.arange(N0, dtype=np.float64) + 1.0) / N0
    c1 = (np.arange(N1, dtype=np.float64) + 1.0) / N1
    U = np.stack([c0 ** int(i) for (i, _j) in g.exps_k])
    V = np.stack([c1 ** int(j) for (_i, j) in g.exps_k])
    sp = exact_sep_weighted_spectra([FJp], FIp, U, V, prof=prof)
    return PexactShared(mI=mI, mJ=mJ, momI_o=momI_o, momJ_g=momJ_g, sp=sp)


# ---------------------------------------------------------------------------
# Greek tables
# ---------------------------------------------------------------------------


def pexact_greek_tables(I: jnp.ndarray, J: jnp.ndarray, cfg: SFFTConfig,
                        shared: Optional[PexactShared] = None):
    """(Comg, Cgam, Cthe, Cphi, Cdel[, (Pbs, Pss, Pgs, Pts)]) unscaled CC
    tables: smooth-involving terms exact f64 (moment algebra), fluct x fluct
    via the sliced pair-FFT windows at cfg.pexact_prof."""
    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = jnp.dtype(cfg.dtype)
    SP, SG, dmu = g.SP, g.SG, g.dmu
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    if shared is None:
        shared = pexact_plane_spectra(I.astype(dt), J.astype(dt), cfg)
    mI, mJ, momI_o, momJ_g, sp = shared
    exps_k, exps_b = g.exps_k, g.exps_b
    Fij, Fpq = len(exps_k), len(exps_b)
    ax0o, ax1o, ax0g, ax1g = g.ax0o, g.ax1o, g.ax0g, g.ax1g

    # +-w moment window is a central slice of the +-2w one
    momI_g = MomentSet(
        M=momI_o.M,
        RS=momI_o.RS[w0: 3 * w0 + 1],
        CS=momI_o.CS[w1: 3 * w1 + 1],
        CNR=momI_o.CNR[w0: 3 * w0 + 1, w1: 3 * w1 + 1],
    )

    # S_a coeffs: mu_I * beta_a — exponent-shifted embeddings
    PA = jnp.zeros((Fij, SP, SP), dt)
    for k, (i, j) in enumerate(exps_k):
        PA = PA.at[k, i: i + dmu + 1, j: j + dmu + 1].set(mI)
    mJ_pad = jnp.zeros((1, SP, SP), dt).at[0, : dmu + 1, : dmu + 1].set(mJ)
    TQ = jnp.zeros((Fpq, SP, SP), dt)
    for k, (p, q) in enumerate(exps_b):
        TQ = TQ.at[k, p, q].set(1.0)

    def fluct_mom(momG: MomentSet, mcoef, ax0, ax1) -> MomentSet:
        pm = poly_moment_set(
            jnp.zeros((SP, SP), dt).at[: dmu + 1, : dmu + 1].set(mcoef),
            (ax0.S.shape[0] - 1) // 2, (ax1.S.shape[0] - 1) // 2,
            SP, SG, ax0, ax1,
        )
        return MomentSet(M=momG.M - pm.M, RS=momG.RS - pm.RS,
                         CS=momG.CS - pm.CS, CNR=momG.CNR - pm.CNR)

    momFI_o = fluct_mom(momI_o, mI, ax0o, ax1o)
    momFI_g = fluct_mom(momI_g, mI, ax0g, ax1g)
    momFb_o = shift_moment_set(momFI_o, exps_k, SP)
    momFa_g = shift_moment_set(momFI_g, exps_k, SP)

    # --- OMG smooth terms -------------------------------------------------
    momSb_o = poly_moment_set(PA, 2 * w0, 2 * w1, SP, SG, ax0o, ax1o)
    SS = polycorr(PA, momSb_o, ax0o, ax1o)                 # CC(S_a, S_b)
    SF = polycorr(PA, momFb_o, ax0o, ax1o)                 # CC(S_a, F_b)
    FS = jnp.transpose(SF, (1, 0, 2, 3))[:, :, ::-1, ::-1]

    # --- fluct x fluct via ONE sliced windowed-correlation pass -----------
    # (same merged-pairs trick as greek_tables_exact: the THE window +-w is a
    # central slice of the +-2w one, and all pairs pad to one lane width)
    prof = SliceProfile(*cfg.pexact_prof)
    iu, ju = np.triu_indices(Fij)
    ia = np.concatenate([iu + 1, np.arange(Fij) + 1])
    jb = np.concatenate([ju + 1, np.zeros(Fij, np.int64)])
    spec_all = CPair(sp.rh[: 1 + Fij], sp.rl[: 1 + Fij],
                     sp.ih[: 1 + Fij], sp.il[: 1 + Fij])
    cc = exact_corr_window(spec_all, spec_all, N0, N1, 2 * w0, 2 * w1,
                           pairs=(ia, jb), prof=prof)
    n_omg = len(iu)
    FF = jnp.zeros((Fij, Fij, 4 * w0 + 1, 4 * w1 + 1), cc.dtype)
    FF = FF.at[iu, ju].set(cc[:n_omg])
    FF = FF.at[ju, iu].set(cc[:n_omg, ::-1, ::-1])
    FFJwin = cc[n_omg:, w0: 3 * w0 + 1, w1: 3 * w1 + 1]
    Comg = SS + SF + FS + FF.astype(dt)

    # --- GAM: fully exact (moment algebra, no FFT at all) ------------------
    momTq = poly_moment_set(TQ, w0, w1, SP, SG, ax0g, ax1g)
    SS_gam = polycorr(PA, momTq, ax0g, ax1g)               # CC(S_a, T_q)
    FT = polycorr(TQ, momFa_g, ax0g, ax1g)                 # CC(T_q, F_a)
    Cgam = SS_gam + jnp.transpose(FT, (1, 0, 2, 3))[:, :, ::-1, ::-1]

    # --- THE ---------------------------------------------------------------
    SJ = polycorr(PA, momJ_g, ax0g, ax1g)                  # CC(S_a, J) exact
    FSJ = polycorr(mJ_pad, momFa_g, ax0g, ax1g)[0][:, ::-1, ::-1]
    Cthe = SJ + FSJ + FFJwin.astype(dt)

    # --- PHI / DEL: closed form --------------------------------------------
    Cphi = jnp.asarray(
        np.array([[float(ax0g.ps[i1 + i2] * ax1g.ps[j1 + j2])
                   for (i2, j2) in exps_b] for (i1, j1) in exps_b]), dt)
    Cdel = jnp.stack([momJ_g.M[i, j] for (i, j) in exps_b])

    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    # --- union tables -> SEPARATE-VARYING blocks (same as core/peel.py) ----
    Fk = g.Fk_only
    Fs = Fij - Fk
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[:Fk, Fk:, win0, win1]
    Pss = Comg[Fk:, Fk:, 2 * w0, 2 * w1]
    Pgs = Cgam[Fk:, :, w0, w1]
    Pts = Cthe[Fk:, w0, w1]

    def pad_k(x, axes):
        pads = [(0, 0)] * x.ndim
        for ax in axes:
            pads[ax] = (0, Fk - Fs)
        return jnp.pad(x, pads)

    extra = (pad_k(Pbs, [1]), pad_k(Pss, [0, 1]), pad_k(Pgs, [0]),
             pad_k(Pts, [0]))
    return Comg[:Fk, :Fk], Cgam[:Fk], Cthe[:Fk], Cphi, Cdel, extra


# ---------------------------------------------------------------------------
# difference construction
# ---------------------------------------------------------------------------


def fdiff_pexact(cfg: SFFTConfig, solution: jnp.ndarray, I: jnp.ndarray,
                 J: jnp.ndarray, shared: Optional[PexactShared] = None
                 ) -> jnp.ndarray:
    """Exact-grade difference via the peel split.

    D = J - SCALE * sum_ij circconv(I * beta_ij, Astd_ij) - bg. With
    I = P_I + F_I, J = P_J + F_J:

      fluct part   (F_J - SCALE * sum K'_ij . FF_ij) — the spectral model sum
                   of fdiff_exact on the FLUCT spectra (reduced profile),
                   inverse-transformed at the same profile (the difference
                   spectrum is fluctuation-scale: the smooth mass never
                   enters this pipeline);
      smooth part  P_J - SCALE * conv(P_I-planes) - bg: the circular conv of
                   a polynomial plane with a small kernel is closed-form —
                   shifted-coeff algebra (ax.S) for the main term plus
                   per-lag wrap-correction polynomials (ax.D) on the
                   <= w-wide boundary bands; the main term plus P_J and the
                   background fold into ONE polynomial evaluated in pair
                   arithmetic, the band corrections are tiny strip einsums.

    Reference semantics: Construct_FDIFF (sfft/sfftcore/SFFTSubtract.py:
    771-816) and its SEPARATE-VARYING variant (sfft/BSplineSFFT.py:2430-2528).
    """
    from sfft_jax.core.fdiff import _phase_matrices, split_solution

    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    N1h = N1 // 2 + 1
    dt = jnp.dtype(cfg.dtype)
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    prof = SliceProfile(*cfg.pexact_prof)
    if shared is None:
        shared = pexact_plane_spectra(I.astype(dt), J.astype(dt), cfg)
    mI, mJ, _momI_o, _momJ_g, sp = shared
    Fk = g.Fk_only
    Fs = len(g.exps_k) - Fk          # union scaling planes (0 if ENTANGLED)

    a_ijab, b_pq = split_solution(cfg, solution)
    a00 = a_ijab[:, w0, w1]
    s_nc = jnp.sum(a_ijab, axis=(1, 2)) - a00

    # --- spectral fluct model (mirror of fdiff_exact on fluct spectra) -----
    W0, W1 = _phase_matrices(cfg, half=True)
    Ap = a_ijab.at[:, w0, w1].set(0.0)
    Adat = pair_from_f64(jnp.swapaxes(Ap, 1, 2))
    T1 = _cmatmul_sliced(Adat, W0.real.T.copy(), W0.imag.T.copy())
    T1m = CPair(*(None if v is None else jnp.swapaxes(v, -1, -2) for v in T1))
    K = _cmatmul_sliced(T1m, W1.real.copy(), W1.imag.copy())   # (i, u, v)

    def shift_pair(P, c):
        c32 = c.astype(jnp.float32)
        cres = (c - c32.astype(jnp.float64)).astype(jnp.float32)
        h, e = _two_sum(P.rh, jnp.broadcast_to(c32, P.rh.shape))
        return CPair(h, P.rl + e + cres, P.ih, P.il)

    def scale_pair(P, c):
        c32 = c.astype(jnp.float32)
        cres = (c - c32.astype(jnp.float64)).astype(jnp.float32)
        pr, er = _two_prod(P.rh, jnp.broadcast_to(c32, P.rh.shape))
        pi, ei = _two_prod(P.ih, jnp.broadcast_to(c32, P.ih.shape))
        return CPair(pr, er + P.rl * c32 + P.rh * cres,
                     pi, ei + P.il * c32 + P.ih * cres)

    def addp(acc, term):
        if acc is None:
            return term
        hr, er = _two_sum(acc[0], term.rh)
        hi, ei = _two_sum(acc[2], term.ih)
        return (hr, acc[1] + term.rl + er, hi, acc[3] + term.il + ei)

    acc = None
    for i in range(Fk):
        c_i = (a00[i] - s_nc[i]) if not separate_varying else -s_nc[i]
        Ki = shift_pair(CPair(K.rh[i], K.rl[i], K.ih[i], K.il[i]), c_i)
        FFi = CPair(sp.rh[1 + i], sp.rl[1 + i], sp.ih[1 + i], sp.il[1 + i])
        acc = addp(acc, _pair_hadamard_conj(
            FFi, CPair(Ki.rh, Ki.rl, -Ki.ih, -Ki.il)))
    if separate_varying:
        for i in range(Fs):
            FSi = CPair(sp.rh[1 + Fk + i], sp.rl[1 + Fk + i],
                        sp.ih[1 + Fk + i], sp.il[1 + Fk + i])
            acc = addp(acc, scale_pair(FSi, a00[i]))

    m = scale_pair(CPair(acc[0], acc[1], acc[2], acc[3]),
                   jnp.float64(cfg.SCALE))
    dr, er = _two_sum(sp.rh[0], -m.rh)
    di, ei = _two_sum(sp.ih[0], -m.ih)
    FD = CPair(dr, sp.rl[0] - m.rl + er, di, sp.il[0] - m.il + ei)

    # inverse of the Hermitian half (axis-0 first at half width, then the
    # weight-2 fold + real-only axis-1 inverse — same as fdiff_exact)
    fold = np.full(N1h, 2.0)
    fold[0] = 1.0
    if N1 % 2 == 0:
        fold[-1] = 1.0
    foldj = jnp.asarray(fold, jnp.float32)
    FDw = CPair(FD.rh * foldj, FD.rl * foldj, FD.ih * foldj, FD.il * foldj)

    def mv(v):
        return None if v is None else jnp.swapaxes(v, -1, -2)

    zt = exact_dft_axis(CPair(mv(FDw.rh), mv(FDw.rl), mv(FDw.ih),
                              mv(FDw.il)), N0, inverse=True, prof=prof)
    z = CPair(mv(zt.rh), mv(zt.rl), mv(zt.ih), mv(zt.il))
    if N1 % 2 == 0:
        from sfft_jax.core.exact_fft import exact_idft_halfin_real

        y = exact_idft_halfin_real(z, N1, prof=prof)
    else:
        pad = N1 - N1h
        zp = CPair(*(None if v is None else jnp.pad(v, ((0, 0), (0, pad)))
                     for v in z))
        y = exact_dft_axis(zp, N1, inverse=True, real_out=True, prof=prof)
    Dfl = _pair_mul_static_rr(y, np.float64(1.0 / (N0 * N1)))

    # --- smooth model: closed-form shift algebra ----------------------------
    dmu, dk = g.dmu, cfg.kernel_basis.degree
    ds = cfg.scaling_basis.degree if separate_varying else 0
    db = cfg.bg_basis.degree
    SPc = dmu + dk + 1                      # conv coeff exponents per axis
    SPt = max(SPc, dmu + ds + 1, db + 1)    # total smooth poly exponents
    axs0 = axis_static(N0, w0, SPc, 2 * SPc + 2)
    axs1 = axis_static(N1, w1, SPc, 2 * SPc + 2)
    S0 = jnp.asarray(_intern(axs0.S))       # (L0, SPc, SPc), lag -w0..w0
    D0 = jnp.asarray(_intern(axs0.D))
    S1 = jnp.asarray(_intern(axs1.S))
    D1 = jnp.asarray(_intern(axs1.D))

    exps_kk = ref_basis_exponents(cfg.kernel_basis)
    Cij = jnp.zeros((Fk, SPc, SPc), dt)
    for k, (i, j) in enumerate(exps_kk):
        Cij = Cij.at[k, i: i + dmu + 1, j: j + dmu + 1].set(mI)
    if separate_varying:
        # non-center offsets act on I*beta with effective center -(sum-a00)
        Astd = a_ijab.at[:, w0, w1].set(-s_nc)
    else:
        from sfft_jax.core.fdiff import standard_kernel_coeffs

        Astd = standard_kernel_coeffs(cfg, a_ijab)
    Cab = jnp.einsum("iab,ist->abst", Astd, Cij,
                     precision=lax.Precision.HIGHEST)   # (L0, L1, SPc, SPc)
    # main shifted-coeff term, wrap-correction coeff stacks
    Cm = jnp.einsum("asu,abst,btv->uv", S0, Cab, S1,
                    precision=lax.Precision.HIGHEST)
    Gx = jnp.einsum("asu,abst,btv->auv", D0, Cab, S1,
                    precision=lax.Precision.HIGHEST)    # (L0, SPc, SPc)
    Gy = jnp.einsum("asu,abst,btv->buv", S0, Cab, D1,
                    precision=lax.Precision.HIGHEST)    # (L1, SPc, SPc)
    Gc = jnp.einsum("asu,abst,btv->abuv", D0, Cab, D1,
                    precision=lax.Precision.HIGHEST)

    # total main polynomial: P_J - SCALE*conv_main - bg (- SCALE*a00.P*sigma)
    s = cfg.SCALE
    Ctot = jnp.zeros((SPt, SPt), dt)
    Ctot = Ctot.at[: dmu + 1, : dmu + 1].add(mJ)
    Ctot = Ctot.at[:SPc, :SPc].add(-s * Cm)
    Bbg = jnp.zeros((SPt, SPt), dt)
    Bbg = Bbg.at[g.exps_b[:, 0], g.exps_b[:, 1]].add(b_pq)
    Ctot = Ctot - Bbg
    if separate_varying:
        exps_s = ref_basis_exponents(cfg.scaling_basis)
        for k, (i, j) in enumerate(exps_s):
            Ctot = Ctot.at[i: i + dmu + 1, j: j + dmu + 1].add(-s * a00[k] * mI)
    main = pair_poly_plane(Ctot, N0, N1)

    # combine fluct + main in pair arithmetic; ONE f64 materialization
    h, e = _two_sum(Dfl.rh, main.rh)
    D = h.astype(jnp.float64) + (Dfl.rl + main.rl + e)

    # --- wrap-correction strips (f64, tiny) ---------------------------------
    pow0 = np.stack([axs0.c ** u for u in range(SPc)], axis=1)   # (N0, SPc)
    pow1 = np.stack([axs1.c ** v for v in range(SPc)], axis=1)   # (N1, SPc)
    U_top = jnp.asarray(_intern(pow0[:w0]))
    U_bot = jnp.asarray(_intern(pow0[N0 - w0:]))
    V_left = jnp.asarray(_intern(pow1[:w1]))
    V_right = jnp.asarray(_intern(pow1[N1 - w1:]))
    P0 = jnp.asarray(_intern(pow0))
    P1 = jnp.asarray(_intern(pow1))

    if w0:
        # top rows x in [0, w0): lags a > x  -> suffix-cum over Gx[w0+1:]
        cum_top = jnp.cumsum(Gx[w0 + 1:][::-1], axis=0)[::-1]
        corr_top = jnp.einsum("xu,xuv,yv->xy", U_top, cum_top, P1,
                              precision=lax.Precision.HIGHEST)
        # bottom rows x = N0-w0+xi: lags a <= -(w0-xi) -> prefix-cum Gx[:w0]
        cum_bot = jnp.cumsum(Gx[:w0], axis=0)
        corr_bot = jnp.einsum("xu,xuv,yv->xy", U_bot, cum_bot, P1,
                              precision=lax.Precision.HIGHEST)
        D = D.at[:w0].add(-s * corr_top)
        D = D.at[N0 - w0:].add(-s * corr_bot)
    if w1:
        cum_l = jnp.cumsum(Gy[w1 + 1:][::-1], axis=0)[::-1]
        corr_l = jnp.einsum("xu,yuv,yv->xy", P0, cum_l, V_left,
                            precision=lax.Precision.HIGHEST)
        cum_r = jnp.cumsum(Gy[:w1], axis=0)
        corr_r = jnp.einsum("xu,yuv,yv->xy", P0, cum_r, V_right,
                            precision=lax.Precision.HIGHEST)
        D = D.at[:, :w1].add(-s * corr_l)
        D = D.at[:, N1 - w1:].add(-s * corr_r)
    if w0 and w1:
        def cum2(block, rev0, rev1):
            b = block[::-1] if rev0 else block
            b = jnp.cumsum(b, axis=0)
            b = b[::-1] if rev0 else b
            b2 = b[:, ::-1] if rev1 else b
            b2 = jnp.cumsum(b2, axis=1)
            return b2[:, ::-1] if rev1 else b2

        # (x-strip sel, y-strip sel, Gc block, cum direction)
        corners = [
            (slice(None, w0), slice(None, w1),
             Gc[w0 + 1:, w1 + 1:], True, True, U_top, V_left),
            (slice(None, w0), slice(N1 - w1, None),
             Gc[w0 + 1:, :w1], True, False, U_top, V_right),
            (slice(N0 - w0, None), slice(None, w1),
             Gc[:w0, w1 + 1:], False, True, U_bot, V_left),
            (slice(N0 - w0, None), slice(N1 - w1, None),
             Gc[:w0, :w1], False, False, U_bot, V_right),
        ]
        for sx, sy, blk, rev0, rev1, Ux, Vy in corners:
            cc2 = cum2(blk, rev0, rev1)
            corr = jnp.einsum("xu,xyuv,yv->xy", Ux, cc2, Vy,
                              precision=lax.Precision.HIGHEST)
            D = D.at[sx, sy].add(-s * corr)

    return D.astype(J.dtype)
