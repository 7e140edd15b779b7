"""Piecewise-polynomial (truncated-power) peel: exact-grade Greek assembly for
B-SPLINE spatial bases.

core/peel.py peels each image into smooth polynomial + fluctuation so that
all cancellation-sensitive correlations reduce to exact f64 moments; its shift
algebra requires the spatial basis to be closed under translation — true for
monomials, false for B-splines (shifted knots). This module generalizes the
function space to TRUNCATED POWERS:

    phi_{m,p}(x) = cx^p * 1[x >= T_m],   T_0 = 0 < T_1 < ... (interior knots)

Any degree-k spline with simple interior knots is p0(cx) + sum_m gamma_m
(cx - ct_m)^k 1[x >= T_m] exactly, so every spatial basis function (polynomial
or B-spline) has an exact (M, k+1) coefficient representation. The space is
closed under products (thresholds combine by max), and a shift by lag rho
decomposes into

    main     binomially shifted coeffs on the SAME threshold      -> suffix moments
    sliver   -/+ the shifted poly restricted to [T_m, T_m+rho)    -> knot-sliver moments
    wrap     boundary-strip corrections (as in peel.py)           -> boundary-strip moments

so the moment data per image generalizes from peel.py's {full, row-strip,
col-strip, corner} to the 3x3 product {suffix, knot-sliver, boundary-strip}^2
— nine lag-indexed tensor classes, all computed with exact-f64 contractions
plus small strip/corner prefix sums.

Requirements (asserted; pre-checked by `pw_supported`): the union of interior
knots across the kernel/scaling/background bases must be pairwise >= 2W apart
and >= 2W from the image edges, W = 2*KerHW being the widest lag window, so
sliver indicator masks are constant and slivers stay off the wrap strips.
Reference B-spline configurations (e.g. the JWST/NIRCam setup of
sfft/BSplineSFFT.py:3967-4356) satisfy this comfortably; configs that do not
fall back to the f32 FFT Greek backend.

Replaces the f32 FFT fallback for B-spline configs in the peeled engine;
reference equivalent: the float64 HadProd/FFT Greek loops of
sfft/BSplineSFFT.py:908-3239.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sfft_jax.config import BasisSpec, SFFTConfig
from sfft_jax.core.greek import corr_window_fft
from sfft_jax.core.indices import ref_basis_exponents
from sfft_jax.core.peel import _exact_skinny_matmul, _shiftmat, fit_poly_coeffs, axis_static


# ---------------------------------------------------------------------------
# 1D function representations: coeffs[m, p] of sum_mp c^p 1[x >= T_m]
# ---------------------------------------------------------------------------


def _expand_local_poly(coeffs_desc: np.ndarray, x0: float, P: int) -> np.ndarray:
    """Local poly sum_d coeffs_desc[d] (c - x0)^(D-1-d) -> global power coeffs
    (length P)."""
    D = len(coeffs_desc)
    out = np.zeros(P)
    for d, cd in enumerate(coeffs_desc):
        e = D - 1 - d  # exponent of (c - x0)
        for j in range(e + 1):
            out[j] += cd * comb(e, j) * (-x0) ** (e - j)
    return out


def bspline_axis_reps(
    int_knots: Tuple[float, ...], degree: int, N: int
) -> Tuple[Tuple[int, ...], np.ndarray]:
    """Truncated-power representations of all clamped B-spline basis functions
    on one axis. Returns (thresholds_px, reps) with reps (nf, M, degree+1):
    f(cx) = sum_{m,p} reps[f, m, p] cx^p 1[x >= T_m]; T_0 = 0.

    Matches core/basis.py's knot construction: pixel-unit knot vector
    [0.5]*(k+1) + int_knots + [N+0.5]*(k+1), scaled by 1/N.
    """
    from scipy.interpolate import BSpline, PPoly

    k = degree
    knots = np.concatenate(
        [np.full(k + 1, 0.5), np.asarray(int_knots, np.float64),
         np.full(k + 1, N + 0.5)]
    ) / float(N)
    nfun = len(knots) - k - 1
    P = k + 1

    # threshold pixel indices for the interior knots: x >= T  <=>  cx >= knot
    thr_px = [0]
    for t in np.asarray(int_knots, np.float64):
        T = int(np.ceil(t - 1.0 - 1e-9))
        thr_px.append(T)
    M = len(thr_px)

    reps = np.zeros((nfun, M, P))
    for f in range(nfun):
        coef = np.zeros(nfun)
        coef[f] = 1.0
        pp = PPoly.from_spline((knots, coef, k), extrapolate=False)
        # global poly of the span covering the first pixel (cx = 1/N)
        c0 = 1.0 / N
        spans = pp.x  # breakpoints
        # map each interior knot to its span index in pp
        def span_of(cval):
            j = np.searchsorted(spans, cval + 1e-12) - 1
            return int(np.clip(j, 0, pp.c.shape[1] - 1))

        j0 = span_of(c0)
        reps[f, 0] = _expand_local_poly(pp.c[:, j0], spans[j0], P)
        prev = reps[f, 0].copy()
        acc = prev.copy()
        for m, t in enumerate(np.asarray(int_knots, np.float64) / float(N),
                              start=1):
            j = span_of(t)
            cur = _expand_local_poly(pp.c[:, j], spans[j], P)
            reps[f, m] = cur - acc
            acc = cur
    return tuple(thr_px), reps


def poly_axis_reps(degree: int) -> Tuple[Tuple[int, ...], np.ndarray]:
    """Monomials c^0..c^degree as trivial single-threshold reps."""
    P = degree + 1
    reps = np.zeros((P, 1, P))
    for i in range(P):
        reps[i, 0, i] = 1.0
    return (0,), reps


def basis_axis_reps(spec: BasisSpec, axis: int, N: int):
    if spec.kind == "polynomial":
        return poly_axis_reps(spec.degree)
    knots = spec.int_knots_x if axis == 0 else spec.int_knots_y
    return bspline_axis_reps(knots, spec.degree, N)


def embed_reps(reps: np.ndarray, thr_src: Tuple[int, ...],
               thr_all: Tuple[int, ...], P: int) -> np.ndarray:
    """Re-index reps onto a larger threshold list and pad powers to P."""
    nf, Ms, Ps = reps.shape
    out = np.zeros((nf, len(thr_all), P))
    pos = [thr_all.index(t) for t in thr_src]
    for m, mm in enumerate(pos):
        out[:, mm, :Ps] = reps[:, m, :]
    return out


# ---------------------------------------------------------------------------
# static per-axis data
# ---------------------------------------------------------------------------


class PWAxis(NamedTuple):
    N: int
    w: int                    # lag window half-width (R = 2w+1)
    thr: Tuple[int, ...]      # thresholds, thr[0] = 0; K = M-1 interior knots
    c: np.ndarray             # (N,) scaled coords
    sufps: np.ndarray         # (M, E+1) suffix power sums  sum_{x>=T_m} c^e
    pref: np.ndarray          # (w+1, E+1) boundary prefix sums over x < r
    suff: np.ndarray          # (w+1, E+1) boundary suffix sums over x >= N-r
    slv: np.ndarray           # (K, R, E+1) lag-indexed sliver power sums:
                              #   rho>0: [T_k, T_k+rho); rho<0: [T_k-|rho|, T_k)
    S: np.ndarray             # (R, SP, SP) binomial shift matrices
    W: np.ndarray             # (R, SP, SP) wrapped-shift matrices (c -/+ 1)
    lags: np.ndarray          # (R,)


@lru_cache(maxsize=64)
def pw_axis(N: int, w: int, thr: Tuple[int, ...], SP: int, EMAX: int) -> PWAxis:
    assert thr[0] == 0 and list(thr) == sorted(set(thr))
    # slivers extend at most w either side of a knot; they must stay clear of
    # the wrap strips ([0, w) and [N-w, N)) and of each other's knots so the
    # per-sliver indicator masks are constant
    for t in thr[1:]:
        assert 2 * w <= t <= N - 2 * w, (
            f"interior knot at pixel {t} too close to the image edge for the "
            f"piecewise peel (needs margin >= {2*w})")
    for a, b in zip(thr[1:], thr[2:]):
        assert b - a >= 2 * w, (
            "interior knots (union across kernel/scaling/background bases) "
            f"closer than {2*w} px — the piecewise peel's sliver masks need "
            "separation; use shared knot grids or the fft32 backend")

    c = (np.arange(N, dtype=np.float64) + 1.0) / N
    powers = np.stack([c**e for e in range(EMAX + 1)])   # (E+1, N)
    csum = np.concatenate(
        [np.zeros((EMAX + 1, 1)), np.cumsum(powers, axis=1)], axis=1)

    def rsum(lo, hi):  # sum over x in [lo, hi)
        lo, hi = max(lo, 0), min(hi, N)
        if hi <= lo:
            return np.zeros(EMAX + 1)
        return csum[:, hi] - csum[:, lo]

    M = len(thr)
    sufps = np.stack([rsum(t, N) for t in thr])
    pref = np.stack([rsum(0, r) for r in range(w + 1)])
    suff = np.stack([rsum(N - r, N) for r in range(w + 1)])
    lags = np.arange(-w, w + 1)
    K = M - 1
    slv = np.zeros((K, 2 * w + 1, EMAX + 1))
    for kk, t in enumerate(thr[1:]):
        for r, l in enumerate(lags):
            if l > 0:
                slv[kk, r] = rsum(t, t + l)
            elif l < 0:
                slv[kk, r] = rsum(t + l, t)
    S = np.stack([_shiftmat(-l / N, SP) for l in lags])
    W = np.zeros_like(S)
    for r, l in enumerate(lags):
        if l > 0:
            W[r] = _shiftmat(-l / N + 1.0, SP)
        elif l < 0:
            W[r] = _shiftmat(-l / N - 1.0, SP)
    return PWAxis(N=N, w=w, thr=thr, c=c, sufps=sufps, pref=pref, suff=suff,
                  slv=slv, S=S, W=W, lags=lags)


def _suffix_weight_rows(ax: PWAxis, SG: int) -> np.ndarray:
    """(M*SG, N) rows c^u * 1[x >= T_m] for the measured suffix moments."""
    M = len(ax.thr)
    rows = np.zeros((M * SG, ax.N))
    pw = np.stack([ax.c**u for u in range(SG)])
    for m, t in enumerate(ax.thr):
        rows[m * SG : (m + 1) * SG, t:] = pw[:, t:]
    return rows


# masks used both for B-side basis contraction and static rep moments:
#   sliver at knot k (threshold index k, 1-based): rep threshold m2 active iff
#     rho > 0 (fwd sliver [T_k, T_k+rho)):  T_m2 <= T_k  (m2 <= k)
#     rho < 0 (bwd sliver [T_k-d, T_k)):    T_m2 <  T_k  (m2 <= k-1)
#   boundary strip: top (rho > 0, x < rho): m2 == 0; bottom (rho < 0): all m2.


def _sliver_mask(M: int, lags: np.ndarray) -> np.ndarray:
    """(K, R, M) 0/1: rep-threshold m2 active on the lag-indexed sliver."""
    K = M - 1
    R = len(lags)
    out = np.zeros((K, R, M))
    for k in range(1, M):
        for r, l in enumerate(lags):
            if l > 0:
                out[k - 1, r, : k + 1] = 1.0
            elif l < 0:
                out[k - 1, r, :k] = 1.0
    return out


def _bnd_mask(M: int, lags: np.ndarray) -> np.ndarray:
    """(R, M) 0/1 rep-threshold activity on the lag-indexed boundary strip."""
    R = len(lags)
    out = np.zeros((R, M))
    for r, l in enumerate(lags):
        if l > 0:
            out[r, 0] = 1.0
        elif l < 0:
            out[r, :] = 1.0
    return out

# ---------------------------------------------------------------------------
# measured moment classes of an image (device, exact f64)
# ---------------------------------------------------------------------------


class PWMoments(NamedTuple):
    """Nine lag-indexed moment classes = {suffix M, knot-sliver K, boundary
    strip B}^2. Powers u, v run to SG. Optional leading batch axis on all."""

    MM: jnp.ndarray   # (M0, SG, M1, SG)
    BM: jnp.ndarray   # (R0, SG, M1, SG)
    MB: jnp.ndarray   # (M0, SG, R1, SG)
    BB: jnp.ndarray   # (R0, R1, SG, SG)
    KM: jnp.ndarray   # (K0, R0, SG, M1, SG)
    MK: jnp.ndarray   # (M0, SG, K1, R1, SG)
    KK: jnp.ndarray   # (K0, K1, R0, R1, SG, SG)
    KB: jnp.ndarray   # (K0, R0, R1, SG, SG)
    BK: jnp.ndarray   # (K1, R0, R1, SG, SG)


def pw_moment_set(G: jnp.ndarray, ax0: PWAxis, ax1: PWAxis, SG: int) -> PWMoments:
    """All nine moment classes of image G (N0, N1), exact f64."""
    dt = G.dtype
    N0, N1, w0, w1 = ax0.N, ax1.N, ax0.w, ax1.w
    M0, M1 = len(ax0.thr), len(ax1.thr)
    K0, K1 = M0 - 1, M1 - 1
    R0, R1 = 2 * w0 + 1, 2 * w1 + 1

    Wx = jnp.asarray(_suffix_weight_rows(ax0, SG), dt)   # (M0*SG, N0)
    Wy = jnp.asarray(_suffix_weight_rows(ax1, SG), dt)   # (M1*SG, N1)

    # MM
    MM = (_exact_skinny_matmul(Wx, G) @ Wy.T).reshape(M0, SG, M1, SG)

    # x rows contracted with y suffix weights, for all x-local classes
    def xrows_ysuf(rows):        # (nr, N1) -> (nr, M1*SG)
        return rows @ Wy.T

    cp0 = lambda idx: jnp.asarray(
        np.stack([ax0.c[idx] ** u for u in range(SG)]), dt)
    cp1 = lambda idx: jnp.asarray(
        np.stack([ax1.c[idx] ** v for v in range(SG)]), dt)

    # BM: boundary strips x<l (top, prefix) / x>=N-|l| (bottom, suffix)
    top = xrows_ysuf(G[:w0]) if w0 else jnp.zeros((0, M1 * SG), dt)
    bot = xrows_ysuf(G[N0 - w0:]) if w0 else jnp.zeros((0, M1 * SG), dt)
    Ttop = cp0(np.arange(w0))[:, :, None] * top[None]        # (SG, w0, Q)
    Tbot = cp0(np.arange(N0 - w0, N0))[:, :, None] * bot[None]
    pf = jnp.cumsum(Ttop, axis=1)                            # sum_{x<l}
    sf = jnp.cumsum(Tbot[:, ::-1, :], axis=1)                # sum_{x>=N-|l|}
    BM = jnp.concatenate(
        [sf[:, ::-1, :].transpose(1, 0, 2),                  # l=-w..-1
         jnp.zeros((1, SG, M1 * SG), dt),
         pf.transpose(1, 0, 2)], axis=0).reshape(R0, SG, M1, SG)

    # KM: knot slivers; strip rows [T-w, T+w)
    KMs = []
    for t in ax0.thr[1:]:
        rows = xrows_ysuf(G[t - w0 : t + w0])                # (2w0, Q)
        cw = cp0(np.arange(t - w0, t + w0))                  # (SG, 2w0)
        T = cw[:, :, None] * rows[None]
        fw = jnp.cumsum(T[:, w0:, :], axis=1)                # [T, T+d)
        bw = jnp.cumsum(T[:, :w0, :][:, ::-1, :], axis=1)    # [T-d, T)
        km = jnp.concatenate(
            [bw[:, ::-1, :].transpose(1, 0, 2),
             jnp.zeros((1, SG, M1 * SG), dt),
             fw.transpose(1, 0, 2)], axis=0)
        KMs.append(km)
    KM = (jnp.stack(KMs).reshape(K0, R0, SG, M1, SG) if K0 else
          jnp.zeros((0, R0, SG, M1, SG), dt))

    # MB / MK: mirrors with x contracted by suffix weights
    def ycols_xsuf(cols):        # (N0, nc) -> (M0*SG, nc)
        return _exact_skinny_matmul(Wx, cols) if cols.shape[1] else \
            jnp.zeros((M0 * SG, 0), dt)

    left = ycols_xsuf(G[:, :w1])
    right = ycols_xsuf(G[:, N1 - w1:])
    Tl = cp1(np.arange(w1))[:, None, :] * left[None]          # (SG, Q, w1)
    Tr = cp1(np.arange(N1 - w1, N1))[:, None, :] * right[None]
    pfy = jnp.cumsum(Tl, axis=2)
    sfy = jnp.cumsum(Tr[:, :, ::-1], axis=2)
    MB = jnp.concatenate(
        [sfy[:, :, ::-1].transpose(2, 1, 0),                  # (e, Q, SG)
         jnp.zeros((1, M0 * SG, SG), dt),
         pfy.transpose(2, 1, 0)], axis=0)
    MB = MB.transpose(1, 0, 2).reshape(M0, SG, R1, SG)

    MKs = []
    for t in ax1.thr[1:]:
        cols = ycols_xsuf(G[:, t - w1 : t + w1])              # (Q, 2w1)
        cwv = cp1(np.arange(t - w1, t + w1))                  # (SG, 2w1)
        T = cwv[:, None, :] * cols[None]
        fw = jnp.cumsum(T[:, :, w1:], axis=2)
        bw = jnp.cumsum(T[:, :, :w1][:, :, ::-1], axis=2)
        mk = jnp.concatenate(
            [bw[:, :, ::-1].transpose(2, 1, 0),
             jnp.zeros((1, M0 * SG, SG), dt),
             fw.transpose(2, 1, 0)], axis=0)                  # (e, Q, SG)
        MKs.append(mk.transpose(1, 0, 2))                      # (Q, e, SG)
    if K1:
        MK = jnp.stack(MKs, axis=0)                            # (K1, Q, e, SG)
        MK = MK.transpose(1, 0, 2, 3).reshape(M0, SG, K1, R1, SG)
    else:
        MK = jnp.zeros((M0, SG, 0, R1, SG), dt)

    # 2D local blocks (boundary corners, knot corners, knot x boundary):
    # each is a lag-indexed rectangle sum over a small power-weighted block,
    # taken from padded 2D prefix sums. The x/y index sets are concatenations
    # (boundary: first w rows + last w rows) so slices are remapped:
    def bidx(N, w):  # boundary index set: [0, w) then [N-w, N)
        return np.concatenate([np.arange(w), np.arange(N - w, N)])

    def bnd_slice(l, w):
        return slice(0, l) if l > 0 else slice(2 * w + l, 2 * w)

    def knot_slice(l, w):
        return slice(w, w + l) if l > 0 else slice(w + l, w)

    def block2d_idx(xidx, yidx, xsl, ysl):
        """Lag-indexed rectangle sums over a power-weighted block, as ONE
        vectorized 4-term gather over all (R0, R1) lag pairs (the slice-per-lag
        version traced O(R0*R1) HLO ops and blew up compile time)."""
        blk = G[np.ix_(xidx, yidx)]
        cwx = cp0(xidx)
        cwy = cp1(yidx)
        T = jnp.einsum("ux,vy,xy->uvxy", cwx, cwy, blk)
        P = jnp.pad(jnp.cumsum(jnp.cumsum(T, axis=2), axis=3),
                    ((0, 0), (0, 0), (1, 0), (1, 0)))
        xa = np.zeros(R0, np.int32); xb = np.zeros(R0, np.int32)
        ya = np.zeros(R1, np.int32); yb = np.zeros(R1, np.int32)
        msk = np.ones((R0, R1))
        for i, l0 in enumerate(range(-w0, w0 + 1)):
            s = xsl(l0) if l0 else slice(0, 0)
            xa[i], xb[i] = s.start, s.stop
            if l0 == 0:
                msk[i, :] = 0.0
        for j, l1 in enumerate(range(-w1, w1 + 1)):
            s = ysl(l1) if l1 else slice(0, 0)
            ya[j], yb[j] = s.start, s.stop
            if l1 == 0:
                msk[:, j] = 0.0
        out = (P[:, :, xb[:, None], yb[None, :]]
               - P[:, :, xa[:, None], yb[None, :]]
               - P[:, :, xb[:, None], ya[None, :]]
               + P[:, :, xa[:, None], ya[None, :]])     # (SG, SG, R0, R1)
        return out.transpose(2, 3, 0, 1) * jnp.asarray(msk, dt)[:, :, None, None]

    BB = block2d_idx(bidx(N0, w0), bidx(N1, w1),
                     lambda l: bnd_slice(l, w0), lambda l: bnd_slice(l, w1)) \
        if (w0 and w1) else jnp.zeros((R0, R1, SG, SG), dt)

    KKs = []
    for t0 in ax0.thr[1:]:
        row = []
        for t1 in ax1.thr[1:]:
            row.append(block2d_idx(
                np.arange(t0 - w0, t0 + w0), np.arange(t1 - w1, t1 + w1),
                lambda l: knot_slice(l, w0), lambda l: knot_slice(l, w1)))
        KKs.append(jnp.stack(row) if row else
                   jnp.zeros((0, R0, R1, SG, SG), dt))
    KK = (jnp.stack(KKs) if K0 and K1 else
          jnp.zeros((K0, K1, R0, R1, SG, SG), dt))

    KBs = []
    for t0 in ax0.thr[1:]:
        KBs.append(block2d_idx(
            np.arange(t0 - w0, t0 + w0), bidx(N1, w1),
            lambda l: knot_slice(l, w0), lambda l: bnd_slice(l, w1)))
    KB = (jnp.stack(KBs) if K0 and w1 else jnp.zeros((K0, R0, R1, SG, SG), dt))

    BKs = []
    for t1 in ax1.thr[1:]:
        BKs.append(block2d_idx(
            bidx(N0, w0), np.arange(t1 - w1, t1 + w1),
            lambda l: bnd_slice(l, w0), lambda l: knot_slice(l, w1)))
    BK = (jnp.stack(BKs) if K1 and w0 else jnp.zeros((K1, R0, R1, SG, SG), dt))

    return PWMoments(MM=MM, BM=BM, MB=MB, BB=BB, KM=KM, MK=MK, KK=KK,
                     KB=KB, BK=BK)

# ---------------------------------------------------------------------------
# static moment channels of analytic separable planes
# ---------------------------------------------------------------------------


def _suffix_ct(ax: PWAxis, SG: int, P: int):
    """SUF[m1, m2, u, p] = sufps[max(m1, m2), u+p]."""
    M = len(ax.thr)
    SUF = np.zeros((M, M, SG, P))
    for m1 in range(M):
        for m2 in range(M):
            mg = max(m1, m2)
            for p in range(P):
                SUF[m1, m2, :, p] = ax.sufps[mg, p : p + SG]
    return SUF


def pw_static_channels(rep, ax: PWAxis, SG: int):
    """Moment-channel vectors of analytic 1D function(s) sum rep[.., m, p]
    c^p 1[x>=T_m]. rep: (..., M, P), possibly traced. Returns
    (SufV (..., M, SG), SlvV (..., K, R, SG), BndV (..., R, SG)) mirroring the
    measured classes' axis conventions."""
    M = len(ax.thr)
    P = rep.shape[-1]
    K, R = M - 1, 2 * ax.w + 1
    SUF = _suffix_ct(ax, SG, P)
    rep = jnp.asarray(rep)
    SufV = jnp.einsum("...mp,nmup->...nu", rep, jnp.asarray(SUF, rep.dtype))

    smask = _sliver_mask(M, ax.lags)                      # (K, R, M)
    SLV = np.zeros((K, R, M, SG, P))
    for k in range(K):
        for r in range(R):
            for m2 in range(M):
                if smask[k, r, m2]:
                    for p in range(P):
                        SLV[k, r, m2, :, p] = ax.slv[k, r, p : p + SG]
    SlvV = jnp.einsum("...mp,krmup->...kru", rep, jnp.asarray(SLV, rep.dtype))

    bmask = _bnd_mask(M, ax.lags)                         # (R, M)
    BND = np.zeros((R, M, SG, P))
    for r, l in enumerate(ax.lags):
        if l == 0:
            continue
        sp = ax.pref[l] if l > 0 else ax.suff[-l]
        for m2 in range(M):
            if bmask[r, m2]:
                for p in range(P):
                    BND[r, m2, :, p] = sp[p : p + SG]
    BndV = jnp.einsum("...mp,rmup->...ru", rep, jnp.asarray(BND, rep.dtype))
    return SufV, SlvV, BndV


def pw_static_moments(C, chx, chy) -> PWMoments:
    """PWMoments of the plane(s) sum_st C[s, t] fx_s(x) fy_t(y), where chx/chy
    are channel triplets with leading (s/t, b) axes — b is the output batch.
    C: (ns, nt), possibly traced.

    Contract C with the (tiny) x channels first, then build each class as an
    unrolled sum of broadcast outer products over t — the big class tensors
    never go through an f64 dot."""
    Sx, Kx, Bx = chx                     # (ns, B, M0, U) / (ns,B,K0,R0,U) / ..
    Sy, Ky, By = chy
    C = jnp.asarray(C)
    ns, nt = C.shape

    def cmix(X):
        """CX[t, ...] = sum_s C[s, t] X[s, ...] (tiny tensors)."""
        out = []
        for t in range(nt):
            acc = 0.0
            for s in range(ns):
                acc = acc + C[s, t] * X[s]
            out.append(acc)
        return out

    CSx, CKx, CBx = cmix(Sx), cmix(Kx), cmix(Bx)

    def join(CX, Y, xsh, ysh):
        """sum_t CX[t][xsh-broadcast] * Y[t][ysh-broadcast]."""
        acc = 0.0
        for t in range(nt):
            acc = acc + CX[t][xsh] * Y[t][ysh]
        return acc

    s_ = slice(None)
    n = None
    return PWMoments(
        # MM (b, m, u, l, v)
        MM=join(CSx, Sy, (s_, s_, s_, n, n), (s_, n, n, s_, s_)),
        # BM (b, r, u, l, v)
        BM=join(CBx, Sy, (s_, s_, s_, n, n), (s_, n, n, s_, s_)),
        # MB (b, m, u, e, v)
        MB=join(CSx, By, (s_, s_, s_, n, n), (s_, n, n, s_, s_)),
        # BB (b, r, e, u, v)
        BB=join(CBx, By, (s_, s_, n, s_, n), (s_, n, s_, n, s_)),
        # KM (b, k, r, u, l, v)
        KM=join(CKx, Sy, (s_, s_, s_, s_, n, n), (s_, n, n, n, s_, s_)),
        # MK (b, m, u, k, e, v)
        MK=join(CSx, Ky, (s_, s_, s_, n, n, n), (s_, n, n, s_, s_, s_)),
        # KK (b, k, j, r, e, u, v)
        KK=join(CKx, Ky, (s_, s_, n, s_, n, s_, n), (s_, n, s_, n, s_, n, s_)),
        # KB (b, k, r, e, u, v)
        KB=join(CKx, By, (s_, s_, s_, n, s_, n), (s_, n, n, s_, n, s_)),
        # BK (b, j, r, e, u, v)
        BK=join(CBx, Ky, (s_, n, s_, n, s_, n), (s_, s_, n, s_, n, s_)),
    )


def mom_sub(a: PWMoments, b: PWMoments) -> PWMoments:
    return PWMoments(*(x - y for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# B-side basis contraction: moments of G * beta_b from moments of G
# ---------------------------------------------------------------------------


def pw_contract_basis(mom: PWMoments, RepX, RepY, ax0: PWAxis, ax1: PWAxis,
                      SGo: int) -> PWMoments:
    """Moment classes of G*beta_b for every basis function b, from the classes
    of G. RepX/RepY: (F, M, P) 1D reps of the per-b separable factors. Output
    tensors gain a leading b axis; powers truncated to SGo.

    All contractions are over tiny (threshold, power) dims with large batch
    outputs — unrolled into broadcast multiply-adds."""
    M0, M1 = len(ax0.thr), len(ax1.thr)
    P = RepX.shape[-1]
    dt = mom.MM.dtype
    RepX = jnp.asarray(RepX, dt)
    RepY = jnp.asarray(RepY, dt)
    RCx = jnp.cumsum(RepX, axis=1)     # RCx[b, j, p] = sum_{m<=j} RepX[b,m,p]
    RCy = jnp.cumsum(RepY, axis=1)
    B = RepX.shape[0]

    def suf_step(T, Rep, m_ax, u_ax):
        """out[b, n, u, rest] = sum_{m2,p} Rep[b,m2,p] T[max(n,m2), u+p]."""
        T = jnp.moveaxis(T, (m_ax, u_ax), (0, 1))
        M = T.shape[0]
        bsh = (slice(None),) + (None,) * (T.ndim - 1)
        rows = []
        for n in range(M):
            acc = 0.0
            for m2 in range(M):
                g = max(n, m2)
                for p in range(P):
                    acc = acc + Rep[:, m2, p][bsh] * T[g, p : p + SGo]
            rows.append(acc)
        out = jnp.stack(rows, axis=1)                    # (B, M, SGo, rest)
        return jnp.moveaxis(out, (1, 2), (m_ax + 1, u_ax + 1))

    def slv_step(T, Rep, RC, k_ax, r_ax, u_ax, lags):
        """Sliver classes: the rep restricted to the sliver at knot k is
        constant per threshold: coeff = RC[:, k] on fwd (lag>0) slivers,
        RC[:, k-1] on bwd."""
        T = jnp.moveaxis(T, (k_ax, r_ax, u_ax), (0, 1, 2))
        K, R = T.shape[0], T.shape[1]
        fwd = lags > 0
        out = 0.0
        bsh = (slice(None), slice(None), slice(None)) + (None,) * (T.ndim - 2)
        for p in range(P):
            cb = RC[:, 0:K, p]                           # RC[k-1] for k=1..K
            cfw = RC[:, 1 : K + 1, p]                    # RC[k]
            c = jnp.where(jnp.asarray(fwd)[None, None, :],
                          cfw[:, :, None], cb[:, :, None])  # (B, K, R)
            out = out + c[bsh] * T[None, :, :, p : p + SGo]
        return jnp.moveaxis(out, (1, 2, 3), (k_ax + 1, r_ax + 1, u_ax + 1))

    def bnd_step(T, Rep, RC, r_ax, u_ax, lags):
        """Boundary strips: top (lag>0) sees only m2=0; bottom sees all."""
        T = jnp.moveaxis(T, (r_ax, u_ax), (0, 1))
        out = 0.0
        bsh = (slice(None), slice(None)) + (None,) * (T.ndim - 1)
        for p in range(P):
            c = jnp.where(jnp.asarray(lags > 0)[None, :],
                          Rep[:, 0, p][:, None], RC[:, -1, p][:, None])
            out = out + c[bsh] * T[None, :, p : p + SGo]
        return jnp.moveaxis(out, (1, 2), (r_ax + 1, u_ax + 1))

    # x-step then y-step per class (axis positions shift by 1 after the
    # leading b axis appears; y-steps use the b-sharing variants below)
    def suf_step_y(T, Rep, l_ax, v_ax):
        T = jnp.moveaxis(T, (l_ax, v_ax), (1, 2))        # (B, M, SGin, rest)
        M = T.shape[1]
        bsh = (slice(None),) + (None,) * (T.ndim - 2)
        rows = []
        for n in range(M):
            acc = 0.0
            for m2 in range(M):
                g = max(n, m2)
                for p in range(P):
                    acc = acc + Rep[:, m2, p][bsh] * T[:, g, p : p + SGo]
            rows.append(acc)
        out = jnp.stack(rows, axis=1)
        return jnp.moveaxis(out, (1, 2), (l_ax, v_ax))

    def slv_step_y(T, Rep, RC, k_ax, e_ax, v_ax, lags):
        T = jnp.moveaxis(T, (k_ax, e_ax, v_ax), (1, 2, 3))
        K = T.shape[1]
        out = 0.0
        bsh = (slice(None), slice(None), slice(None)) + (None,) * (T.ndim - 3)
        for p in range(P):
            cb = RC[:, 0:K, p]
            cfw = RC[:, 1 : K + 1, p]
            c = jnp.where(jnp.asarray(lags > 0)[None, None, :],
                          cfw[:, :, None], cb[:, :, None])
            out = out + c[bsh] * T[:, :, :, p : p + SGo]
        return jnp.moveaxis(out, (1, 2, 3), (k_ax, e_ax, v_ax))

    def bnd_step_y(T, Rep, RC, e_ax, v_ax, lags):
        T = jnp.moveaxis(T, (e_ax, v_ax), (1, 2))
        out = 0.0
        bsh = (slice(None), slice(None)) + (None,) * (T.ndim - 2)
        for p in range(P):
            c = jnp.where(jnp.asarray(lags > 0)[None, :],
                          Rep[:, 0, p][:, None], RC[:, -1, p][:, None])
            out = out + c[bsh] * T[:, :, p : p + SGo]
        return jnp.moveaxis(out, (1, 2), (e_ax, v_ax))

    lg0, lg1 = ax0.lags, ax1.lags
    # MM (m,u,l,v)
    MM = suf_step_y(suf_step(mom.MM, RepX, 0, 1), RepY, 3, 4)
    # BM (r,u,l,v)
    BM = suf_step_y(bnd_step(mom.BM, RepX, RCx, 0, 1, lg0), RepY, 3, 4)
    # MB (m,u,e,v)
    MB = bnd_step_y(suf_step(mom.MB, RepX, 0, 1), RepY, RCy, 3, 4, lg1)
    # BB (r,e,u,v)
    BB = bnd_step_y(bnd_step(mom.BB, RepX, RCx, 0, 2, lg0), RepY, RCy, 2, 4,
                    lg1)
    # KM (k,r,u,l,v)
    KM = suf_step_y(slv_step(mom.KM, RepX, RCx, 0, 1, 2, lg0), RepY, 4, 5)
    # MK (m,u,k,e,v)
    MK = slv_step_y(suf_step(mom.MK, RepX, 0, 1), RepY, RCy, 3, 4, 5, lg1)
    # KK (k,j,r,e,u,v)
    KK = slv_step_y(slv_step(mom.KK, RepX, RCx, 0, 2, 4, lg0), RepY, RCy,
                    2, 4, 6, lg1)
    # KB (k,r,e,u,v)
    KB = bnd_step_y(slv_step(mom.KB, RepX, RCx, 0, 1, 3, lg0), RepY, RCy,
                    3, 5, lg1)
    # BK (j,r,e,u,v)
    BK = slv_step_y(bnd_step(mom.BK, RepX, RCx, 1, 3, lg0), RepY, RCy,
                    1, 3, 5, lg1)
    return PWMoments(MM=MM, BM=BM, MB=MB, BB=BB, KM=KM, MK=MK, KK=KK,
                     KB=KB, BK=BK)


# ---------------------------------------------------------------------------
# windowed correlation of an analytic truncated-power plane against moments
# ---------------------------------------------------------------------------


def _bnd_transfer(ax: PWAxis, SP: int) -> np.ndarray:
    """TW[m, r, s, u]: boundary-strip correction coefficients for A-side
    threshold m at lag index r:
      top strip (l>0):    W[r] - (m==0) S[r]
      bottom strip (l<0): (m==0) W[r] - S[r]
      l == 0: zero."""
    M = len(ax.thr)
    R = len(ax.lags)
    TW = np.zeros((M, R, SP, SP))
    for m in range(M):
        for r, l in enumerate(ax.lags):
            if l > 0:
                TW[m, r] = ax.W[r] - (1.0 if m == 0 else 0.0) * ax.S[r]
            elif l < 0:
                TW[m, r] = (1.0 if m == 0 else 0.0) * ax.W[r] - ax.S[r]
    return TW


def pw_corr(A2: jnp.ndarray, mom: PWMoments, ax0: PWAxis, ax1: PWAxis
            ) -> jnp.ndarray:
    """CC(plane_A, G_b)[rho, eps] = sum_xy A(x, y) G_b(x+rho, y+eps) (circular)
    for analytic planes with truncated-power rep A2 (a, M0, SP, M1, SP),
    against (possibly b-batched) moment classes of G. Returns (a, b, R0, R1);
    squeezes b if the moment classes carry no batch axis.

    These contractions have tiny contracted dims over large batch dims, so
    the u/v transfer contractions are UNROLLED into broadcast multiply-adds,
    and the final (m, s, l, t) contraction against the A-side rep runs as
    ONE f64 matmul per channel."""
    dt = A2.dtype
    M0, M1 = len(ax0.thr), len(ax1.thr)
    K0, K1 = M0 - 1, M1 - 1
    SP = A2.shape[2]
    R0, R1 = 2 * ax0.w + 1, 2 * ax1.w + 1
    squeeze = mom.MM.ndim == 4
    if squeeze:
        mom = PWMoments(*(t[None] for t in mom))
    B = mom.MM.shape[0]
    a_n = A2.shape[0]

    S0 = jnp.asarray(ax0.S, dt)
    S1 = jnp.asarray(ax1.S, dt)
    sg0 = np.where(ax0.lags > 0, -1.0, np.where(ax0.lags < 0, 1.0, 0.0))
    sg1 = np.where(ax1.lags > 0, -1.0, np.where(ax1.lags < 0, 1.0, 0.0))
    KS0 = jnp.asarray(sg0[:, None, None] * ax0.S, dt)   # (R0, SP, SP)
    KS1 = jnp.asarray(sg1[:, None, None] * ax1.S, dt)
    TW0 = jnp.asarray(_bnd_transfer(ax0, SP), dt)       # (M0, R0, SP, SP)
    TW1 = jnp.asarray(_bnd_transfer(ax1, SP), dt)

    uu = slice(0, SP)
    out = jnp.zeros((a_n, B, R0, R1), dt)

    def finish(A_slc, Z2):
        """Z2 (B, XM, s, YL, t, r, e); A_slc (a, XM, SP, YL, SP)."""
        K = int(np.prod(Z2.shape[1:5]))
        W = A_slc.reshape(a_n, K)
        G = jnp.moveaxis(Z2.reshape(B, K, R0 * R1), 1, 0).reshape(K, -1)
        return _exact_skinny_matmul(W, G).reshape(a_n, B, R0, R1)

    def x_suffix(Z1):
        """Z1 (b, m, u, YL, t, e) -> Z2 (b, m, s, YL, t, r, e)."""
        Z2 = 0.0
        for u in range(SP):
            Zu = Z1[:, :, u]                              # (b, m, YL, t, e)
            s0 = S0[:, :, u].T                            # (s, r)
            Z2 = Z2 + (Zu[:, :, None, :, :, None, :]
                       * s0[None, None, :, None, None, :, None])
        return Z2

    def x_sliver(Z1):
        """Z1 (b, k, YL, t, r, e) x-lag-resolved -> Z2 (b,k,s,YL,t,r,e)."""
        Z2 = 0.0
        for u in range(SP):
            ks = KS0[:, :, u].T                           # (s, r)
            Z2 = Z2 + (Z1[u][:, :, None, :, :, :, :]
                       * ks[None, None, :, None, None, :, None])
        return Z2

    def x_bnd(Z1):
        """Z1 list over u of (b, YL, t, r, e) -> Z2 (b, m, s, YL, t, r, e)."""
        Z2 = 0.0
        for u in range(SP):
            tw = jnp.transpose(TW0[:, :, :, u], (0, 2, 1))  # (m, s, r)
            Z2 = Z2 + (Z1[u][:, None, None, :, :, :, :]
                       * tw[None, :, :, None, None, :, None])
        return Z2

    # ---- channel 1: (suffix, suffix) — mom.MM (b, m, u, l, v) -----------
    MM = mom.MM[:, :, uu, :, uu]
    Z1 = 0.0
    for v in range(SP):
        Z1 = Z1 + MM[..., v][..., None, None] * S1[:, :, v].T
    # Z1 (b, m, u, l, t, e)
    out = out + finish(A2, x_suffix(Z1))

    # ---- channel 2: (suffix, sliver) — mom.MK (b, m, u, k, e, v) --------
    if K1:
        MK = mom.MK[:, :, uu, :, :, uu]
        Z1 = 0.0
        for v in range(SP):
            ks = KS1[:, :, v]                             # (e, t)
            Z1 = Z1 + MK[..., v][..., None] * ks[None, None, None, None, :, :]
        # Z1 (b, m, u, k, e, t) -> (b, m, u, k, t, e)
        Z1 = jnp.transpose(Z1, (0, 1, 2, 3, 5, 4))
        out = out + finish(A2[:, :, :, 1:, :], x_suffix(Z1))

    # ---- channel 3: (suffix, bnd) — mom.MB (b, m, u, e, v) --------------
    MB = mom.MB[:, :, uu, :, uu]
    Z1 = 0.0
    for v in range(SP):
        tw = jnp.transpose(TW1[:, :, :, v], (1, 0, 2))    # (e, l, t)
        Z1 = Z1 + (MB[..., v][:, :, :, :, None, None]
                   * tw[None, None, None, :, :, :])
    # Z1 (b, m, u, e, l, t) -> (b, m, u, l, t, e)
    Z1 = jnp.transpose(Z1, (0, 1, 2, 4, 5, 3))
    out = out + finish(A2, x_suffix(Z1))

    # ---- channel 4: (sliver, suffix) — mom.KM (b, k, r, u, l, v) --------
    if K0:
        KM = mom.KM[:, :, :, uu, :, uu]
        Z1 = 0.0
        for v in range(SP):
            Z1 = Z1 + KM[..., v][..., None, None] * S1[:, :, v].T
        # Z1 (b, k, r, u, l, t, e); x_sliver wants per-u (b, k, l, t, r, e)
        Z1u = [jnp.transpose(Z1[:, :, :, u], (0, 1, 3, 4, 2, 5))
               for u in range(SP)]
        out = out + finish(A2[:, 1:], x_sliver(Z1u))

    # ---- channel 5: (sliver, sliver) — mom.KK (b, k, j, r, e, u, v) -----
    if K0 and K1:
        KK = mom.KK[:, :, :, :, :, uu, uu]
        Z1 = 0.0
        for v in range(SP):
            ks = KS1[:, :, v]                             # (e, t)
            Z1 = Z1 + (KK[..., v][..., None]
                       * ks[None, None, None, None, :, None, :])
        # Z1 (b, k, j, r, e, u, t); per-u (b, k, j, t, r, e)
        Z1u = [jnp.transpose(Z1[:, :, :, :, :, u], (0, 1, 2, 5, 3, 4))
               for u in range(SP)]
        out = out + finish(A2[:, 1:, :, 1:, :], x_sliver(Z1u))

    # ---- channel 6: (sliver, bnd) — mom.KB (b, k, r, e, u, v) -----------
    if K0:
        KB = mom.KB[:, :, :, :, uu, uu]
        Z1 = 0.0
        for v in range(SP):
            tw = jnp.transpose(TW1[:, :, :, v], (1, 0, 2))  # (e, l, t)
            Z1 = Z1 + (KB[..., v][..., None, None]
                       * tw[None, None, None, :, None, :, :])
        # Z1 (b, k, r, e, u, l, t); per-u (b, k, l, t, r, e)
        Z1u = [jnp.transpose(Z1[:, :, :, :, u], (0, 1, 4, 5, 2, 3))
               for u in range(SP)]
        out = out + finish(A2[:, 1:], x_sliver(Z1u))

    # ---- channel 7: (bnd, suffix) — mom.BM (b, r, u, l, v) --------------
    BM = mom.BM[:, :, uu, :, uu]
    Z1 = 0.0
    for v in range(SP):
        Z1 = Z1 + BM[..., v][..., None, None] * S1[:, :, v].T
    # Z1 (b, r, u, l, t, e); per-u (b, l, t, r, e)
    Z1u = [jnp.transpose(Z1[:, :, u], (0, 2, 3, 1, 4)) for u in range(SP)]
    out = out + finish(A2, x_bnd(Z1u))

    # ---- channel 8: (bnd, sliver) — mom.BK (b, j, r, e, u, v) -----------
    if K1:
        BK = mom.BK[:, :, :, :, uu, uu]
        Z1 = 0.0
        for v in range(SP):
            ks = KS1[:, :, v]                             # (e, t)
            Z1 = Z1 + (BK[..., v][..., None]
                       * ks[None, None, None, :, None, :])
        # Z1 (b, j, r, e, u, t); per-u (b, j, t, r, e)
        Z1u = [jnp.transpose(Z1[:, :, :, :, u], (0, 1, 4, 2, 3))
               for u in range(SP)]
        out = out + finish(A2[:, :, :, 1:, :], x_bnd(Z1u))

    # ---- channel 9: (bnd, bnd) — mom.BB (b, r, e, u, v) -----------------
    BB = mom.BB[:, :, :, uu, uu]
    Z1 = 0.0
    for v in range(SP):
        tw = jnp.transpose(TW1[:, :, :, v], (1, 0, 2))    # (e, l, t)
        Z1 = Z1 + (BB[..., v][..., None, None]
                   * tw[None, None, :, None, :, :])
    # Z1 (b, r, e, u, l, t); per-u (b, l, t, r, e)
    Z1u = [jnp.transpose(Z1[:, :, :, u], (0, 3, 4, 1, 2)) for u in range(SP)]
    out = out + finish(A2, x_bnd(Z1u))

    if squeeze:
        out = out[:, 0]
    return out


# ---------------------------------------------------------------------------
# the piecewise-polynomial peeled Greek backend
# ---------------------------------------------------------------------------


def _slice_mom(mom: PWMoments, w0: int, w1: int, W0: int, W1: int) -> PWMoments:
    """Central-window slice: classes measured at window +-W become the +-w
    classes (full moments are window-independent; strips/slivers at depth <= w
    are the central lag slice)."""
    s0 = slice(W0 - w0, W0 + w0 + 1)
    s1 = slice(W1 - w1, W1 + w1 + 1)
    return PWMoments(
        MM=mom.MM,
        BM=mom.BM[s0], MB=mom.MB[:, :, s1], BB=mom.BB[s0, s1],
        KM=mom.KM[:, s0], MK=mom.MK[:, :, :, s1], KK=mom.KK[:, :, s0, s1],
        KB=mom.KB[:, s0, s1], BK=mom.BK[:, s0, s1],
    )


def _monomial_channel_reps(M: int, dmu: int, P: int) -> np.ndarray:
    """(dmu+1, 1, M, P) reps of the monomials c^s (threshold 0 only)."""
    out = np.zeros((dmu + 1, 1, M, P))
    for s in range(dmu + 1):
        out[s, 0, 0, s] = 1.0
    return out


def _shifted_basis_reps(Rep: np.ndarray, dmu: int) -> np.ndarray:
    """(F, M, P) basis reps -> (dmu+1, F, M, P+dmu) reps of c^s * f_b."""
    F, M, P = Rep.shape
    out = np.zeros((dmu + 1, F, M, P + dmu))
    for s in range(dmu + 1):
        out[s, :, :, s : s + P] = Rep
    return out


def peeled_pw_greek_tables(I: jnp.ndarray, J: jnp.ndarray, cfg: SFFTConfig):
    """(Comg, Cgam, Cthe, Cphi, Cdel) unscaled CC tables for arbitrary
    polynomial / B-spline bases, mixed-precision: exact f64 for every term
    touching smooth content, fluct x fluct via FFT in cfg.fluct_dtype.

    Piecewise generalization of core/peel.py:peeled_greek_tables (same term
    structure: OMG = SS+SF+FS+FF, GAM = SS+FS exact, THE = SJ+FSJ+FFJ)."""
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dmu = cfg.peel_degree
    fd = jnp.dtype(cfg.fluct_dtype)
    dt = jnp.dtype(cfg.dtype)

    # --- 1D reps of every basis on the UNION threshold grid ---------------
    from sfft_jax.core.basis import basis_1d_tables

    specs = [cfg.kernel_basis, cfg.bg_basis]
    if separate_varying:
        specs.append(cfg.scaling_basis)
    axreps = []
    for spec in specs:
        tx, rx = basis_axis_reps(spec, 0, N0)
        ty, ry = basis_axis_reps(spec, 1, N1)
        axreps.append(((tx, rx), (ty, ry)))
    thr0 = tuple(sorted(set().union(*(set(a[0][0]) for a in axreps))))
    thr1 = tuple(sorted(set().union(*(set(a[1][0]) for a in axreps))))

    degs = [s.degree for s in specs]
    kmax = max(cfg.kernel_basis.degree,
               cfg.scaling_basis.degree if separate_varying else 0)
    SPA = max(dmu + kmax, cfg.bg_basis.degree) + 1
    SG = SPA + max(degs)          # B-side contraction adds basis powers
    EMAX = SG + SPA + dmu + 2

    Pk = max(degs) + 1
    embx = [embed_reps(a[0][1], a[0][0], thr0, Pk) for a in axreps]
    emby = [embed_reps(a[1][1], a[1][0], thr1, Pk) for a in axreps]

    exps_k = ref_basis_exponents(cfg.kernel_basis)
    Fk_only = len(exps_k)
    RepXa = embx[0][exps_k[:, 0]]          # (Fij, M0, Pk)
    RepYa = emby[0][exps_k[:, 1]]
    Uk_tab, Vk_tab = basis_1d_tables(cfg.kernel_basis, N0, N1)
    Ua = Uk_tab[:, exps_k[:, 0]].T         # (Fij, N0) evaluated x factors
    Va = Vk_tab[:, exps_k[:, 1]].T
    if separate_varying:
        exps_s = ref_basis_exponents(cfg.scaling_basis)
        RepXa = np.concatenate([RepXa, embx[2][exps_s[:, 0]]], axis=0)
        RepYa = np.concatenate([RepYa, emby[2][exps_s[:, 1]]], axis=0)
        Us_tab, Vs_tab = basis_1d_tables(cfg.scaling_basis, N0, N1)
        Ua = np.concatenate([Ua, Us_tab[:, exps_s[:, 0]].T], axis=0)
        Va = np.concatenate([Va, Vs_tab[:, exps_s[:, 1]].T], axis=0)
    Fij = RepXa.shape[0]

    exps_b = ref_basis_exponents(cfg.bg_basis)
    Fpq = len(exps_b)
    RepXq = embx[1][exps_b[:, 0]]
    RepYq = emby[1][exps_b[:, 1]]
    Uq_tab, Vq_tab = basis_1d_tables(cfg.bg_basis, N0, N1)

    ax0o = pw_axis(N0, 2 * w0, thr0, SPA, EMAX)
    ax1o = pw_axis(N1, 2 * w1, thr1, SPA, EMAX)
    ax0g = pw_axis(N0, w0, thr0, SPA, EMAX)
    ax1g = pw_axis(N1, w1, thr1, SPA, EMAX)
    M0, M1 = len(thr0), len(thr1)

    I = I.astype(dt)
    J = J.astype(dt)

    # --- measured moment classes ------------------------------------------
    momI_o = pw_moment_set(I, ax0o, ax1o, SG)
    momI_g = _slice_mom(momI_o, w0, w1, 2 * w0, 2 * w1)
    momJ_g = pw_moment_set(J, ax0g, ax1g, SG)

    # --- smooth fits (exact plain power moments = MM[0, :, 0, :]) ---------
    axs0 = axis_static(N0, 1, 1, EMAX)
    axs1 = axis_static(N1, 1, 1, EMAX)
    mI = fit_poly_coeffs(momI_o.MM[0, :, 0, :], dmu, axs0, axs1)
    mJ = fit_poly_coeffs(momJ_g.MM[0, :, 0, :], dmu, axs0, axs1)

    # --- fluct moment classes = measured - static(smooth) ------------------
    mono_x = _monomial_channel_reps(M0, dmu, dmu + 1)
    mono_y = _monomial_channel_reps(M1, dmu, dmu + 1)

    def smooth_static(mcoef, ax0_, ax1_):
        chx = pw_static_channels(jnp.asarray(mono_x, dt), ax0_, SG)
        chy = pw_static_channels(jnp.asarray(mono_y, dt), ax1_, SG)
        mom = pw_static_moments(mcoef, chx, chy)
        return PWMoments(*(t[0] for t in mom))   # squeeze b=1

    momFI_o = mom_sub(momI_o, smooth_static(mI, ax0o, ax1o))
    momFI_g = _slice_mom(momFI_o, w0, w1, 2 * w0, 2 * w1)
    momFJ_g = mom_sub(momJ_g, smooth_static(mJ, ax0g, ax1g))

    # --- B-contracted fluct classes: F * beta_b ----------------------------
    momFb_o = pw_contract_basis(momFI_o, RepXa, RepYa, ax0o, ax1o, SPA)
    momFa_g = pw_contract_basis(momFI_g, RepXa, RepYa, ax0g, ax1g, SPA)

    # --- A-side 2D reps -----------------------------------------------------
    # S_a = smooth_I * beta_a: thresholds from beta_a, powers conv with mI
    RXs = jnp.asarray(_shifted_basis_reps(RepXa, dmu)[..., :SPA], dt)
    RYs = jnp.asarray(_shifted_basis_reps(RepYa, dmu)[..., :SPA], dt)
    A2_Sa = jnp.einsum("uv,uams,valt->amslt", mI, RXs, RYs)

    TQ2 = np.zeros((Fpq, M0, SPA, M1, SPA))
    TQ2[:, :, :Pk, :, :Pk] = np.einsum("qmp,qlt->qmplt", RepXq, RepYq)
    TQ2 = jnp.asarray(TQ2, dt)
    mJ2 = jnp.zeros((1, M0, SPA, M1, SPA), dt).at[
        0, 0, : dmu + 1, 0, : dmu + 1].set(mJ)

    # --- OMG ---------------------------------------------------------------
    sx = pw_static_channels(jnp.asarray(
        _shifted_basis_reps(RepXa, dmu)[..., : SPA], dt), ax0o, SPA)
    sy = pw_static_channels(jnp.asarray(
        _shifted_basis_reps(RepYa, dmu)[..., : SPA], dt), ax1o, SPA)
    momSb_o = pw_static_moments(mI, sx, sy)
    SS = pw_corr(A2_Sa, momSb_o, ax0o, ax1o)
    SF = pw_corr(A2_Sa, momFb_o, ax0o, ax1o)
    FS = jnp.transpose(SF, (1, 0, 2, 3))[:, :, ::-1, ::-1]

    U = jnp.asarray(np.stack([ax0o.c**s for s in range(dmu + 1)]), fd)
    V = jnp.asarray(np.stack([ax1o.c**t for t in range(dmu + 1)]), fd)
    hp = jax.lax.Precision.HIGHEST
    smoothI = jnp.einsum("st,sx,ty->xy", mI.astype(fd), U, V, precision=hp)
    smoothJ = jnp.einsum("st,sx,ty->xy", mJ.astype(fd), U, V, precision=hp)
    FIf = I.astype(fd) - smoothI
    FJf = J.astype(fd) - smoothJ
    Uaf = jnp.asarray(Ua, fd)
    Vaf = jnp.asarray(Va, fd)
    Fplanes = FIf[None] * (Uaf[:, :, None] * Vaf[:, None, :])

    stack = jnp.concatenate([FJf[None], Fplanes], axis=0)
    specs_f = jnp.fft.rfft2(stack)
    specJ = specs_f[0:1]
    specF = specs_f[1:]
    FF = corr_window_fft(specF, specF, N0, N1, 2 * w0, 2 * w1,
                         chunk=cfg.greek_chunk, symmetric=True).astype(dt)
    Comg = SS + SF + FS + FF

    # --- GAM (fully exact) --------------------------------------------------
    qx = pw_static_channels(jnp.asarray(RepXq[None], dt), ax0g, SPA)
    qy = pw_static_channels(jnp.asarray(RepYq[None], dt), ax1g, SPA)
    momTq_g = pw_static_moments(jnp.ones((1, 1), dt), qx, qy)
    SS_gam = pw_corr(A2_Sa, momTq_g, ax0g, ax1g)
    FT = pw_corr(TQ2, momFa_g, ax0g, ax1g)
    FS_gam = jnp.transpose(FT, (1, 0, 2, 3))[:, :, ::-1, ::-1]
    Cgam = SS_gam + FS_gam

    # --- THE ----------------------------------------------------------------
    SJ = pw_corr(A2_Sa, momJ_g, ax0g, ax1g)
    FSJ = pw_corr(mJ2, momFa_g, ax0g, ax1g)[0][:, ::-1, ::-1]
    FFJwin = corr_window_fft(specF, specJ, N0, N1, w0, w1,
                             chunk=cfg.greek_chunk)[:, 0].astype(dt)
    Cthe = SJ + FSJ + FFJwin

    # --- PHI / DEL (exact closed forms) --------------------------------------
    Cphi = jnp.asarray(
        np.array([[np.dot(Uq_tab[:, i1], Uq_tab[:, i2])
                   * np.dot(Vq_tab[:, j1], Vq_tab[:, j2])
                   for (i2, j2) in exps_b] for (i1, j1) in exps_b]), dt)
    Cdel = jnp.einsum("qmp,qlt,mplt->q", jnp.asarray(RepXq, dt),
                      jnp.asarray(RepYq, dt),
                      momJ_g.MM[:, : Pk, :, : Pk])

    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    Fk = Fk_only
    Fs = Fij - Fk
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[:Fk, Fk:, win0, win1]
    Pss = Comg[Fk:, Fk:, 2 * w0, 2 * w1]
    Pgs = Cgam[Fk:, :, w0, w1]
    Pts = Cthe[Fk:, w0, w1]

    def pad_k(x, axes):
        pads = [(0, 0)] * x.ndim
        for axn in axes:
            pads[axn] = (0, Fk - Fs)
        return jnp.pad(x, pads)

    extra = (pad_k(Pbs, [1]), pad_k(Pss, [0, 1]), pad_k(Pgs, [0]),
             pad_k(Pts, [0]))
    return Comg[:Fk, :Fk], Cgam[:Fk], Cthe[:Fk], Cphi, Cdel, extra

def pw_supported(cfg: SFFTConfig) -> bool:
    """Whether the piecewise peel's sliver-separation requirements hold for
    this config (union knot grid vs. lag window), without raising."""
    try:
        specs = [cfg.kernel_basis, cfg.bg_basis]
        if cfg.scaling_mode == "SEPARATE-VARYING":
            specs.append(cfg.scaling_basis)
        for axis, (N, w) in enumerate([(cfg.N0, cfg.w0), (cfg.N1, cfg.w1)]):
            thr = set()
            for spec in specs:
                t, _ = basis_axis_reps(spec, axis, N)
                thr |= set(t)
            thr = sorted(thr)
            W = 2 * w  # widest window (OMG)
            for t in thr[1:]:
                if not (2 * W <= t <= N - 2 * W):
                    return False
            for a, b in zip(thr[1:], thr[2:]):
                if b - a < 2 * W:
                    return False
        return True
    except Exception:
        return False
