"""Smooth/fluctuation-peeled Greek assembly — the mixed-precision engine.

Problem this solves: the SFFT normal equations are built from circular
cross-correlations whose entries suffer catastrophic cancellation under the
delta-basis second differencing (sfft_jax/core/assemble.py). The reference
computes everything in float64; this engine keeps the cancellation-sensitive
parts in exact f64 moments and runs only the small-magnitude remainder
through a complex64 FFT (fast mode), for hardware where complex128 FFTs are
missing or slow.

Design: split each input image exactly as  I = P_I + F_I  where P_I is a
low-degree polynomial fit (the split is exact algebra — any smooth P works).
Every Greek correlation CC(I*beta_a, I*beta_b)[lag] expands into

  poly x poly   -> closed form in static grid power sums            [exact f64]
  poly x fluct  -> weighted moments of the fluctuation image        [exact f64]
  fluct x fluct -> windowed FFT correlation of small-magnitude data [c64 FFT]

The poly terms carry all the large smooth mass and are computed exactly; the
only finite-precision part is fluct x fluct, whose entries are the same order
as the *cancelled* normal-equation entries — so its ~1e-7 relative FFT error
does not get amplified. Circular wrap-around of shifted polynomials is handled
exactly: lags are bounded by 2*w <= 32 px, so wrap corrections only involve
moments over <=32-pixel boundary bands and corners.

Everything data-dependent on the f64 side reduces to ONE moment set per input
image (full-image moments + boundary-band moments + corner blocks), computed
with skinny exact-f64 matmuls; all lag algebra happens on tiny tensors.

With fluct_dtype='float64' the backend is exact end-to-end and is
cross-checked against the plain FFT backend in tests.

Reference equivalents: this replaces HadProd_*/FFT loops of
sfft/sfftcore/SFFTSubtract.py:620-729.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig
from sfft_jax.core.indices import ref_basis_exponents
from sfft_jax.core.greek import corr_window_fft, dot_planes


def _exact_skinny_matmul(P0: jnp.ndarray, G: jnp.ndarray) -> jnp.ndarray:
    """P0 @ G at full precision (a true f64 GEMM for f64 operands)."""
    return jnp.dot(P0, G, precision=jax.lax.Precision.HIGHEST)


# --------------------------------------------------------------------------
# static host-side tensors (exact numpy, cached per geometry)
# --------------------------------------------------------------------------


class AxisStatic(NamedTuple):
    c: np.ndarray        # (N,) scaled coords (x+1)/N
    ps: np.ndarray       # (EMAX+1,) power sums  sum_x c^a
    pref: np.ndarray     # (wmax+1, EMAX+1) prefix sums over x <  r
    suff: np.ndarray     # (wmax+1, EMAX+1) suffix sums over x >= N-r
    S: np.ndarray        # (R, SP, SP) shift matrices for main term
    D: np.ndarray        # (R, SP, SP) wrap-correction delta shift matrices
    lags: np.ndarray     # (R,) lag values -w..w


def _shiftmat(h: float, SP: int) -> np.ndarray:
    """M[s, a] = binom(s, a) * h^(s-a): coeffs of P(c + h) from coeffs of P(c)."""
    from math import comb

    M = np.zeros((SP, SP))
    for s in range(SP):
        for a in range(s + 1):
            M[s, a] = comb(s, a) * h ** (s - a)
    return M


@lru_cache(maxsize=128)
def axis_static(N: int, w: int, SP: int, EMAX: int) -> AxisStatic:
    c = (np.arange(N, dtype=np.float64) + 1.0) / N
    powers = np.stack([c**a for a in range(EMAX + 1)])  # (EMAX+1, N)
    ps = powers.sum(axis=1)
    pref = np.zeros((w + 1, EMAX + 1))
    suff = np.zeros((w + 1, EMAX + 1))
    for r in range(1, w + 1):
        pref[r] = powers[:, :r].sum(axis=1)
        suff[r] = powers[:, N - r :].sum(axis=1)
    lags = np.arange(-w, w + 1)
    S = np.stack([_shiftmat(-l / N, SP) for l in lags])
    D = np.zeros_like(S)
    for k, l in enumerate(lags):
        if l > 0:
            D[k] = _shiftmat(-l / N + 1.0, SP) - S[k]
        elif l < 0:
            D[k] = _shiftmat(-l / N - 1.0, SP) - S[k]
    return AxisStatic(c=c, ps=ps, pref=pref, suff=suff, S=S, D=D, lags=lags)


# --------------------------------------------------------------------------
# device-side moment sets
# --------------------------------------------------------------------------


class MomentSet(NamedTuple):
    """Exact f64 moment data of one image G, sufficient to evaluate
    CC(P, G)[rho, eps] for any poly P with per-axis degree < SP and
    |rho| <= w0, |eps| <= w1."""

    M: jnp.ndarray    # (SG, SG) full moments sum cx^a cy^b G
    RS: jnp.ndarray   # (R0, SG, SG) row-strip moments per rho (0 at rho=0)
    CS: jnp.ndarray   # (R1, SG, SG) col-strip moments per eps
    CNR: jnp.ndarray  # (R0, R1, SG, SG) corner moments


def _powmat(ax: AxisStatic, SG: int, dtype) -> jnp.ndarray:
    return jnp.asarray(np.stack([ax.c**a for a in range(SG)]), dtype)  # (SG, N)


def moment_set(
    G: jnp.ndarray, N0: int, N1: int, w0: int, w1: int, SG: int,
    ax0: AxisStatic, ax1: AxisStatic,
) -> MomentSet:
    """Compute the moment set of image G on device (exact f64 skinny matmuls)."""
    dt = G.dtype
    P0 = _powmat(ax0, SG, dt)  # (SG, N0)
    P1 = _powmat(ax1, SG, dt)  # (SG, N1)
    R0, R1 = 2 * w0 + 1, 2 * w1 + 1

    # full moments: (SG, N0) @ (N0, N1) @ (N1, SG)
    M = _exact_skinny_matmul(P0, G) @ P1.T

    # row strips: need rows [0, w0) and [N0-w0, N0)
    rowmom_top = G[:w0] @ P1.T if w0 else jnp.zeros((0, SG), dt)      # (w0, SG)
    rowmom_bot = G[N0 - w0 :] @ P1.T if w0 else jnp.zeros((0, SG), dt)
    # RS[r] for lag rho>0: sum_{x<rho} cx^a rowmom[x, b]
    cx_top = jnp.asarray(
        np.stack([ax0.c[:w0] ** a for a in range(SG)]), dt
    )  # (SG, w0)
    cx_bot = jnp.asarray(np.stack([ax0.c[N0 - w0 :] ** a for a in range(SG)]), dt)
    # prefix over strip rows
    top_terms = cx_top[:, :, None] * rowmom_top[None, :, :]   # (SG, w0, SG)
    bot_terms = cx_bot[:, :, None] * rowmom_bot[None, :, :]
    top_pref = jnp.cumsum(top_terms, axis=1)                  # sum_{x<rho}
    bot_suff = jnp.cumsum(bot_terms[:, ::-1, :], axis=1)      # sum_{x>=N0-|rho|}
    RS = jnp.zeros((R0, SG, SG), dt)
    if w0:
        # rho = 1..w0 -> index w0+rho ; strip x in [0, rho)
        RS = RS.at[w0 + 1 :].set(jnp.moveaxis(top_pref, 1, 0))
        # rho = -1..-w0 -> index w0+rho ; strip x in [N0-|rho|, N0)
        RS = RS.at[w0 - 1 :: -1].set(jnp.moveaxis(bot_suff, 1, 0))

    colmom_l = (P0 @ G[:, :w1]) if w1 else jnp.zeros((SG, 0), dt)     # (SG, w1)
    colmom_r = (P0 @ G[:, N1 - w1 :]) if w1 else jnp.zeros((SG, 0), dt)
    cy_l = jnp.asarray(np.stack([ax1.c[:w1] ** b for b in range(SG)]), dt)
    cy_r = jnp.asarray(np.stack([ax1.c[N1 - w1 :] ** b for b in range(SG)]), dt)
    l_terms = colmom_l[:, None, :] * cy_l[None, :, :]         # (SG, SG, w1)
    r_terms = colmom_r[:, None, :] * cy_r[None, :, :]
    l_pref = jnp.cumsum(l_terms, axis=2)
    r_suff = jnp.cumsum(r_terms[:, :, ::-1], axis=2)
    CS = jnp.zeros((R1, SG, SG), dt)
    if w1:
        CS = CS.at[w1 + 1 :].set(jnp.moveaxis(l_pref, 2, 0))
        CS = CS.at[w1 - 1 :: -1].set(jnp.moveaxis(r_suff, 2, 0))

    # corners: region x in strip(rho), y in strip(eps) — four corner blocks
    CNR = jnp.zeros((R0, R1, SG, SG), dt)
    if w0 and w1:
        def corner(block, cxp, cyp, flip0, flip1):
            # block: (w0, w1); weighted: T[a, x, y, b] then 2D prefix
            T = cxp[:, :, None, None] * block[None, :, :, None] * cyp.T[None, None, :, :]
            if flip0:
                T = T[:, ::-1]
            if flip1:
                T = T[:, :, ::-1]
            pre = jnp.cumsum(jnp.cumsum(T, axis=1), axis=2)   # (SG, w0, w1, SG)
            return pre

        blocks = {
            (False, False): G[:w0, :w1],
            (False, True): G[:w0, N1 - w1 :],
            (True, False): G[N0 - w0 :, :w1],
            (True, True): G[N0 - w0 :, N1 - w1 :],
        }
        for (f0, f1), blk in blocks.items():
            cxp = cx_bot if f0 else cx_top
            cyp = cy_r if f1 else cy_l
            pre = corner(blk, cxp, cyp, f0, f1)
            # pre[a, k0, k1, b] = moments over |strip|=k0+1, |strip|=k1+1
            sub = jnp.moveaxis(pre, (1, 2), (0, 1))  # (w0, w1, SG, SG)
            if f0 and f1:
                CNR = CNR.at[w0 - 1 :: -1, w1 - 1 :: -1].set(sub)
            elif f0 and not f1:
                CNR = CNR.at[w0 - 1 :: -1, w1 + 1 :].set(sub)
            elif not f0 and f1:
                CNR = CNR.at[w0 + 1 :, w1 - 1 :: -1].set(sub)
            else:
                CNR = CNR.at[w0 + 1 :, w1 + 1 :].set(sub)
    return MomentSet(M=M, RS=RS, CS=CS, CNR=CNR)


def poly_moment_set(
    Q: jnp.ndarray, w0: int, w1: int, SP: int, SG: int,
    ax0: AxisStatic, ax1: AxisStatic,
) -> MomentSet:
    """MomentSet of a *polynomial* plane with coeff stack Q[..., u2, v2]
    (exponents < SP), from static power/prefix sums — no grid work.

    Supports a leading batch axis on Q.
    """
    dt = Q.dtype
    # windowed static tables: PS0[u, u2] = ps0[u + u2]
    idx = np.arange(SG)[:, None] + np.arange(SP)[None, :]
    ps0 = jnp.asarray(ax0.ps[idx], dt)          # (SG, SP)
    ps1 = jnp.asarray(ax1.ps[idx], dt)
    # strips: pref0[rho][u + u2]
    R0, R1 = 2 * w0 + 1, 2 * w1 + 1
    pr0 = np.zeros((R0, SG, SP))
    for k, l in enumerate(range(-w0, w0 + 1)):
        if l > 0:
            pr0[k] = ax0.pref[l][idx]
        elif l < 0:
            pr0[k] = ax0.suff[-l][idx]
    pr1 = np.zeros((R1, SG, SP))
    for k, l in enumerate(range(-w1, w1 + 1)):
        if l > 0:
            pr1[k] = ax1.pref[l][idx]
        elif l < 0:
            pr1[k] = ax1.suff[-l][idx]
    pr0 = jnp.asarray(pr0, dt)
    pr1 = jnp.asarray(pr1, dt)

    hp = jax.lax.Precision.HIGHEST
    M = jnp.einsum("...uv,au,bv->...ab", Q, ps0, ps1, precision=hp)
    RS = jnp.einsum("...uv,rau,bv->...rab", Q, pr0, ps1, precision=hp)
    CS = jnp.einsum("...uv,au,ebv->...eab", Q, ps0, pr1, precision=hp)
    CNR = jnp.einsum("...uv,rau,ebv->...reab", Q, pr0, pr1, precision=hp)
    return MomentSet(M=M, RS=RS, CS=CS, CNR=CNR)


def polycorr(
    P: jnp.ndarray, mom: MomentSet, ax0: AxisStatic, ax1: AxisStatic
) -> jnp.ndarray:
    """CC(poly(P), G)[rho, eps] from G's moment set. Batched:
    P: (..., SP, SP) poly coeffs; mom tensors may carry their own leading batch
    axis ('b'). Returns (...P-batch, ...mom-batch, R0, R1)."""
    dt = P.dtype
    S0 = jnp.asarray(ax0.S, dt)
    D0 = jnp.asarray(ax0.D, dt)
    S1 = jnp.asarray(ax1.S, dt)
    D1 = jnp.asarray(ax1.D, dt)
    Mm, RS, CS, CNR = mom
    if Mm.ndim == 2:  # add singleton mom batch
        Mm, RS, CS, CNR = Mm[None], RS[None], CS[None], CNR[None]
        squeeze = True
    else:
        squeeze = False
    # moment sets may carry more exponents (SG) than the poly side needs (SP)
    SP = S0.shape[1]
    Mm = Mm[..., :SP, :SP]
    RS = RS[..., :SP, :SP]
    CS = CS[..., :SP, :SP]
    CNR = CNR[..., :SP, :SP]
    hp = jax.lax.Precision.HIGHEST
    out = (
        jnp.einsum("ast,rsu,etv,buv->abre", P, S0, S1, Mm, precision=hp)
        + jnp.einsum("ast,rsu,etv,bruv->abre", P, D0, S1, RS, precision=hp)
        + jnp.einsum("ast,rsu,etv,beuv->abre", P, S0, D1, CS, precision=hp)
        + jnp.einsum("ast,rsu,etv,breuv->abre", P, D0, D1, CNR, precision=hp)
    )
    if squeeze:
        out = out[:, 0]
    return out


def shift_moment_set(mom: MomentSet, exps: np.ndarray, SP: int) -> MomentSet:
    """Moment sets of G*beta_k planes from the moment set of G:
    moments of cx^i cy^j G are exponent-shifted moments of G.
    exps: (F, 2) monomial exponents. Output tensors gain leading F axis,
    truncated to SP exponent entries."""
    F = exps.shape[0]
    M = jnp.stack([mom.M[i : i + SP, j : j + SP] for (i, j) in exps])
    RS = jnp.stack([mom.RS[:, i : i + SP, j : j + SP] for (i, j) in exps])
    CS = jnp.stack([mom.CS[:, i : i + SP, j : j + SP] for (i, j) in exps])
    CNR = jnp.stack([mom.CNR[:, :, i : i + SP, j : j + SP] for (i, j) in exps])
    return MomentSet(M=M, RS=RS, CS=CS, CNR=CNR)


def fit_poly_coeffs(
    M: jnp.ndarray, deg: int, ax0: AxisStatic, ax1: AxisStatic, ridge: float = 1e-9
) -> jnp.ndarray:
    """Least-squares polynomial fit of an image from its exact moments.

    Solves the tiny normal system Gram @ m = rhs where Gram[st, uv] =
    sum cx^(s+u) cy^(t+v) (static) and rhs = M[s, t]. Exactness of the peel
    does NOT depend on fit quality, so a small ridge keeps the (Hilbert-like)
    system tame. Returns (deg+1, deg+1) tensor coeffs (total-degree mask)."""
    exps = [(s, t) for s in range(deg + 1) for t in range(deg + 1 - s)]
    n = len(exps)
    G = np.zeros((n, n))
    for a, (s, t) in enumerate(exps):
        for b, (u, v) in enumerate(exps):
            G[a, b] = ax0.ps[s + u] * ax1.ps[t + v]
    # normalize for conditioning
    d = np.sqrt(np.diag(G))
    Gn = G / np.outer(d, d) + ridge * np.eye(n)
    Gn_inv = np.linalg.inv(Gn)
    dt = M.dtype
    rhs = jnp.stack([M[s, t] for (s, t) in exps]) / jnp.asarray(d, dt)
    sol = jnp.asarray(Gn_inv, dt) @ rhs
    sol = sol / jnp.asarray(d, dt)
    out = jnp.zeros((deg + 1, deg + 1), dt)
    for a, (s, t) in enumerate(exps):
        out = out.at[s, t].set(sol[a])
    return out


# --------------------------------------------------------------------------
# the peeled Greek backend
# --------------------------------------------------------------------------


def peeled_greek_tables(
    I: jnp.ndarray,
    J: jnp.ndarray,
    cfg: SFFTConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(Comg, Cgam, Cthe, Cphi, Cdel) unscaled CC tables, mixed-precision:
    exact f64 for every term touching smooth/polynomial content, fluct x fluct
    via FFT in cfg fluct dtype."""
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    if (cfg.kernel_basis.kind != "polynomial"
            or cfg.bg_basis.kind != "polynomial"
            or (separate_varying and cfg.scaling_basis.kind != "polynomial")):
        # B-spline bases: the truncated-power generalization handles them
        from sfft_jax.core.peel_pw import peeled_pw_greek_tables

        return peeled_pw_greek_tables(I, J, cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dmu = cfg.peel_degree
    dk = cfg.kernel_basis.degree
    ds = cfg.scaling_basis.degree if separate_varying else 0
    db = cfg.bg_basis.degree
    SP = dmu + max(dk, ds) + 1         # poly-side exponents (S_a = mu * beta_a)
    SG = SP + max(dk, ds, db)          # moment exponents (F_b = Ftil * beta_b)
    EMAX = 2 * SG + 2
    fd = jnp.dtype(cfg.fluct_dtype)
    dt = jnp.dtype(cfg.dtype)

    exps_k = ref_basis_exponents(cfg.kernel_basis)   # (Fij, 2)
    exps_b = ref_basis_exponents(cfg.bg_basis)       # (Fpq, 2)
    Fk_only = len(exps_k)
    if separate_varying:
        # run the whole machinery over the UNION of kernel and scaling basis
        # functions: the union correlation tables contain the beta-beta,
        # beta-sigma and sigma-sigma blocks the SEPARATE-VARYING assembly needs
        exps_s = ref_basis_exponents(cfg.scaling_basis)
        exps_k = np.concatenate([exps_k, exps_s], axis=0)
    Fij, Fpq = len(exps_k), len(exps_b)

    ax0o = axis_static(N0, 2 * w0, SP, EMAX)   # OMG window +-2w
    ax1o = axis_static(N1, 2 * w1, SP, EMAX)
    ax0g = axis_static(N0, w0, SP, EMAX)       # GAM/THE window +-w
    ax1g = axis_static(N1, w1, SP, EMAX)

    I = I.astype(dt)
    J = J.astype(dt)

    # --- exact moment sets of raw images ------------------------------
    momI_o = moment_set(I, N0, N1, 2 * w0, 2 * w1, SG, ax0o, ax1o)
    # the +-w window set is a central slice of the +-2w one (full moments are
    # window-independent; strips/corners at depth <= w are a subset)
    momI_g = MomentSet(
        M=momI_o.M,
        RS=momI_o.RS[w0 : 3 * w0 + 1],
        CS=momI_o.CS[w1 : 3 * w1 + 1],
        CNR=momI_o.CNR[w0 : 3 * w0 + 1, w1 : 3 * w1 + 1],
    )
    momJ_g = moment_set(J, N0, N1, w0, w1, SG, ax0g, ax1g)

    # --- polynomial peels ----------------------------------------------
    mI = fit_poly_coeffs(momI_o.M, dmu, ax0o, ax1o)          # (dmu+1, dmu+1)
    mJ = fit_poly_coeffs(momJ_g.M, dmu, ax0g, ax1g)

    # S_a coeffs: mu_I * beta_a — exponent-shifted embeddings, (Fij, SP, SP)
    PA = jnp.zeros((Fij, SP, SP), dt)
    for k, (i, j) in enumerate(exps_k):
        PA = PA.at[k, i : i + dmu + 1, j : j + dmu + 1].set(mI)
    mJ_pad = jnp.zeros((1, SP, SP), dt).at[0, : dmu + 1, : dmu + 1].set(mJ)
    mI_pad = jnp.zeros((1, SP, SP), dt).at[0, : dmu + 1, : dmu + 1].set(mI)
    # background basis coeffs (static monomials), (Fpq, SP, SP)
    TQ = jnp.zeros((Fpq, SP, SP), dt)
    for k, (p, q) in enumerate(exps_b):
        TQ = TQ.at[k, p, q].set(1.0)

    # --- fluctuation moment sets (pure algebra, no grid) ---------------
    def fluct_mom(momG: MomentSet, mcoef, ax0, ax1) -> MomentSet:
        pm = poly_moment_set(
            jnp.zeros((SP, SP), dt).at[: dmu + 1, : dmu + 1].set(mcoef),
            (ax0.S.shape[0] - 1) // 2, (ax1.S.shape[0] - 1) // 2, SP, SG, ax0, ax1,
        )
        return MomentSet(
            M=momG.M - pm.M, RS=momG.RS - pm.RS,
            CS=momG.CS - pm.CS, CNR=momG.CNR - pm.CNR,
        )

    momFI_o = fluct_mom(momI_o, mI, ax0o, ax1o)
    momFI_g = fluct_mom(momI_g, mI, ax0g, ax1g)
    momFJ_g = fluct_mom(momJ_g, mJ, ax0g, ax1g)

    # per-basis fluct moment sets: F_b = Ftil * beta_b
    momFb_o = shift_moment_set(momFI_o, exps_k, SP)
    momFa_g = shift_moment_set(momFI_g, exps_k, SP)

    # --- OMG: (Fij, Fij, R0o, R1o) --------------------------------------
    momSb_o = poly_moment_set(PA, 2 * w0, 2 * w1, SP, SG, ax0o, ax1o)
    SS = polycorr(PA, momSb_o, ax0o, ax1o)            # CC(S_a, S_b)
    SF = polycorr(PA, momFb_o, ax0o, ax1o)            # CC(S_a, F_b)
    FS = jnp.transpose(SF, (1, 0, 2, 3))[:, :, ::-1, ::-1]  # CC(F_a, S_b)

    # fluct planes in fluct dtype for the FFT part
    U = jnp.asarray(np.stack([ax0o.c**s for s in range(dmu + 1)]), fd)  # (dmu+1, N0)
    V = jnp.asarray(np.stack([ax1o.c**t for t in range(dmu + 1)]), fd)
    hp = jax.lax.Precision.HIGHEST
    smoothI = jnp.einsum("st,sx,ty->xy", mI.astype(fd), U, V, precision=hp)
    smoothJ = jnp.einsum("st,sx,ty->xy", mJ.astype(fd), U, V, precision=hp)
    FIf = I.astype(fd) - smoothI
    FJf = J.astype(fd) - smoothJ
    Uk = jnp.asarray(np.stack([ax0o.c ** int(i) for i in exps_k[:, 0]]), fd)
    Vk = jnp.asarray(np.stack([ax1o.c ** int(j) for j in exps_k[:, 1]]), fd)
    Fplanes = FIf[None] * (Uk[:, :, None] * Vk[:, None, :])   # (Fij, N0, N1)

    stack = jnp.concatenate([FJf[None], Fplanes], axis=0)
    specs = jnp.fft.rfft2(stack)
    specJ = specs[0:1]
    specF = specs[1:]
    FF = corr_window_fft(specF, specF, N0, N1, 2 * w0, 2 * w1,
                         chunk=cfg.greek_chunk, symmetric=True).astype(dt)
    Comg = SS + SF + FS + FF

    # --- GAM: (Fij, Fpq, R0g, R1g) — fully exact ------------------------
    momTq = poly_moment_set(TQ, w0, w1, SP, SG, ax0g, ax1g)
    SS_gam = polycorr(PA, momTq, ax0g, ax1g)          # CC(S_a, T_q)
    FT = polycorr(TQ, momFa_g, ax0g, ax1g)            # CC(T_q, F_a)
    FS_gam = jnp.transpose(FT, (1, 0, 2, 3))[:, :, ::-1, ::-1]
    Cgam = SS_gam + FS_gam

    # --- THE: (Fij, R0g, R1g) -------------------------------------------
    SJ = polycorr(PA, momJ_g, ax0g, ax1g)             # CC(S_a, J) exact
    FSJ = polycorr(mJ_pad, momFa_g, ax0g, ax1g)[0][:, ::-1, ::-1]  # CC(F_a, S_J)
    FFJwin = corr_window_fft(specF, specJ, N0, N1, w0, w1,
                             chunk=cfg.greek_chunk)[:, 0].astype(dt)
    Cthe = SJ + FSJ + FFJwin

    # --- PHI / DEL: closed form from static sums / moments --------------
    Cphi = jnp.asarray(
        np.array([[float(ax0g.ps[i1 + i2] * ax1g.ps[j1 + j2])
                   for (i2, j2) in exps_b] for (i1, j1) in exps_b]), dt)
    Cdel = jnp.stack([momJ_g.M[i, j] for (i, j) in exps_b])

    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    # --- slice the union tables into the SEPARATE-VARYING blocks --------
    Fk = Fk_only
    Fs = Fij - Fk  # actual scaling dof (engine pads placeholders with zeros)
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[:Fk, Fk:, win0, win1]          # CC(I*beta_a, I*sigma_b), +-w
    Pss = Comg[Fk:, Fk:, 2 * w0, 2 * w1]      # lag 0
    Pgs = Cgam[Fk:, :, w0, w1]                # CC(I*sigma, T)[0]
    Pts = Cthe[Fk:, w0, w1]                   # CC(I*sigma, J)[0]

    def pad_k(x, axes):
        pads = [(0, 0)] * x.ndim
        for ax in axes:
            pads[ax] = (0, Fk - Fs)
        return jnp.pad(x, pads)

    extra = (pad_k(Pbs, [1]), pad_k(Pss, [0, 1]), pad_k(Pgs, [0]),
             pad_k(Pts, [0]))
    return Comg[:Fk, :Fk], Cgam[:Fk], Cthe[:Fk], Cphi, Cdel, extra
