"""Greek-tensor computation as windowed circular cross-correlations.

The reference assembles its normal equations from six "Greek" tensors
(OMG/GAM/PSI/PHI/THE/DEL), each of shape (F, N0, N1), produced by
Hadamard-multiplying full FFT spectra and FFT-ing again
(sfft/sfftcore/SFFTSubtract.py:599-729). It then *reads only a handful of
pixels* of each plane — circular-lag lookups bounded by the kernel half-width
(sfft/sfftcore/SFFTConfigure.py:197-275).

Key identity used here: for real planes A, B,

    Re FFT2( FFT2(A) * conj(FFT2(B)) )[rho, eps]
        = N0*N1 * sum_xy A[x, y] * B[(x+rho) % N0, (y+eps) % N1]
        = N0*N1 * CC(A, B)[rho, eps],

i.e. every Greek value the solver consumes is a circular cross-correlation at a
lag within [-2*w, 2*w]. So we never materialize (F, N0, N1) Greek planes at
all — we compute CC windows directly, via either

  * 'fft'  — batched rfft2 + Hadamard + irfft2 (inputs are real and the
    Hadamard products are Hermitian, so half-spectra suffice; the reference
    uses full complex128 FFTs), then a static corner gather; or
  * 'corr' — FFT-free windowed correlation lowered to lax.conv / matmuls.

Both backends return identical tables and are cross-checked in tests.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np


def _window_row_indices(N: int, w: int) -> np.ndarray:
    """Row indices of irfft output holding CC at lags rho=-w..w (table index
    rho+w): CC[rho] = irfft2(H)[(-rho) % N]."""
    rho = np.arange(-w, w + 1)
    return ((-rho) % N).astype(np.int32)


def _partial_idft_mats(N0: int, N1: int, wx: int, wy: int, cdtype):
    """Static matrices for the windowed inverse transform:
    CC[rho, eps] = Re( E0 @ H_half @ E1 ) with E0[r, u] = exp(2i pi u x_r / N0)
    / (N0*N1), x_r = (-rho_r) % N0, and E1[v, e] folding the Hermitian half
    spectrum (weight 2 for interior v; 1 at v = 0 and the Nyquist column)."""
    rows = _window_row_indices(N0, wx).astype(np.float64)
    cols = _window_row_indices(N1, wy).astype(np.float64)
    N1h = N1 // 2 + 1
    u = np.arange(N0)
    v = np.arange(N1h)
    E0 = np.exp(2j * np.pi * np.outer(rows, u) / N0) / (N0 * N1)
    w = np.full(N1h, 2.0)
    w[0] = 1.0
    if N1 % 2 == 0:
        w[-1] = 1.0
    E1 = w[:, None] * np.exp(2j * np.pi * np.outer(v, cols) / N1)
    return E0.astype(cdtype), E1.astype(cdtype)


def corr_window_fft(
    specA: jnp.ndarray,
    specB: jnp.ndarray,
    N0: int,
    N1: int,
    wx: int,
    wy: int,
    chunk: int = 0,
    method: str = "auto",
    symmetric: bool = False,
) -> jnp.ndarray:
    """CC(A_a, B_b)[rho, eps] for all pairs, lags |rho|<=wx, |eps|<=wy.

    specA: (Fa, N0, N1h) raw rfft2 spectra of A stack; specB likewise (Fb, ...).
    Returns (Fa, Fb, 2*wx+1, 2*wy+1).

    method 'matmul' extracts the lag window via a partial inverse DFT — two
    complex matmuls per pair instead of a full irfft2 (the window has only
    (2wx+1)(2wy+1) points out of N0*N1), never materializing full
    correlation planes. 'irfft' is the full inverse transform + corner
    gather. 'auto' takes 'matmul' on accelerators — on one H100 (700 W)
    the correlation calls of a 4096^2 polynomial 2/2, w=8 config take
    16.0 ms that way against 54.4 ms through irfft (PERF.md) — and 'irfft'
    on the CPU, where the parity oracle keeps the independent route.
    """
    Fa, Fb = specA.shape[0], specB.shape[0]
    if method == "auto":
        method = "irfft" if jax.default_backend() == "cpu" else "matmul"

    if method == "matmul":
        E0, E1 = _partial_idft_mats(N0, N1, wx, wy, np.dtype(specA.dtype))
        E0 = jnp.asarray(E0)
        E1 = jnp.asarray(E1)
        if symmetric and specA is specB:
            # CC(A_b, A_a)[rho] = CC(A_a, A_b)[-rho]: compute the upper
            # triangle only and mirror (1.7x on the dominant pair stage)
            iu, ju = np.triu_indices(Fa)
            H = specA[iu] * jnp.conj(specB)[ju]
            T1 = jnp.einsum("cuv,ve->cue", H, E1,
                            precision=lax.Precision.HIGHEST)
            tri = jnp.real(jnp.einsum("ru,cue->cre", E0, T1,
                                      precision=lax.Precision.HIGHEST))
            full = jnp.zeros((Fa, Fa, 2 * wx + 1, 2 * wy + 1), tri.dtype)
            full = full.at[iu, ju].set(tri)
            full = full.at[ju, iu].set(tri[:, ::-1, ::-1])
            return full
        ia, ib = np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij")
        ia = ia.ravel()
        ib = ib.ravel()
        npairs = Fa * Fb

        specBc = jnp.conj(specB)
        csize = chunk if chunk else npairs
        outs = []
        for k0 in range(0, npairs, csize):
            sel_a = ia[k0 : k0 + csize]
            sel_b = ib[k0 : k0 + csize]
            H = specA[sel_a] * specBc[sel_b]                # (c, N0, N1h)
            T1 = jnp.einsum("cuv,ve->cue", H, E1,
                            precision=lax.Precision.HIGHEST)  # (c, N0, R1)
            outs.append(jnp.real(
                jnp.einsum("ru,cue->cre", E0, T1,
                           precision=lax.Precision.HIGHEST)
            ))
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)

    rows = _window_row_indices(N0, wx)
    cols = _window_row_indices(N1, wy)
    H = specA[:, None, :, :] * jnp.conj(specB)[None, :, :, :]
    H = H.reshape(Fa * Fb, N0, specA.shape[-1])

    def one_chunk(h):
        cc = jnp.fft.irfft2(h, s=(N0, N1))
        return cc[:, rows][:, :, cols]

    if chunk and Fa * Fb > chunk:
        npairs = Fa * Fb
        pad = (-npairs) % chunk
        Hp = jnp.pad(H, ((0, pad), (0, 0), (0, 0)))
        Hp = Hp.reshape(-1, chunk, N0, specA.shape[-1])
        out = lax.map(one_chunk, Hp).reshape(-1, 2 * wx + 1, 2 * wy + 1)[:npairs]
    else:
        out = one_chunk(H)
    return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)


def corr_window_conv(
    A: jnp.ndarray, B: jnp.ndarray, wx: int, wy: int
) -> jnp.ndarray:
    """FFT-free CC(A_a, B_b) window via a VALID correlation conv.

    A: (Fa, N0, N1), B: (Fb, N0, N1) real stacks. B is wrap-padded so the conv
    output pixel (rho+wx, eps+wy) is the circular correlation at lag (rho, eps).
    XLA lowers this to a convolution (im2col matmuls on the CPU).
    """
    Fa, N0, N1 = A.shape
    Fb = B.shape[0]
    Bpad = jnp.pad(B, ((0, 0), (wx, wx), (wy, wy)), mode="wrap")
    # input: (batch=Fb, feat=1, H, W); filter: (out_feat=Fa, in_feat=1, N0, N1)
    out = lax.conv_general_dilated(
        Bpad[:, None, :, :],
        A[:, None, :, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    # out[b, a, rho+wx, eps+wy] = sum_xy Bpad[b, x+rho+wx, y+eps+wy] * A[a, x, y]
    return jnp.transpose(out, (1, 0, 2, 3))


def dot_planes(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Lag-zero correlations only: (Fa, Fb) matrix of plane inner products."""
    Fa = A.shape[0]
    Fb = B.shape[0]
    return jnp.einsum(
        "ap,bp->ab",
        A.reshape(Fa, -1),
        B.reshape(Fb, -1),
        precision=lax.Precision.HIGHEST,
    )


def exact_bg_corr(A: jnp.ndarray, bg_spec, N0: int, N1: int,
                  wx: int, wy: int) -> jnp.ndarray:
    """CC(A_a, T_q)[rho, eps] EXACTLY for separable analytic background
    planes T_q(x,y) = u_p(x) v_q(y) — no FFT and no shift-closure algebra:
    the lag set is static, so circularly SHIFTED basis factors are just
    np.roll'ed value tables, and the correlation reduces to two exact-f64
    skinny matmuls:

        CC[a, (p,q), rho, eps] = sum_xy A_a[x,y] u_p(x+rho) v_q(y+eps)

    Works for any separable basis (polynomial or B-spline, any knots).
    Returns (Fa, Fpq, 2wx+1, 2wy+1) f64."""
    from sfft_jax.core.basis import basis_1d_tables
    from sfft_jax.core.indices import ref_basis_exponents
    from sfft_jax.core.peel import _exact_skinny_matmul

    U, V = basis_1d_tables(bg_spec, N0, N1)       # (N0, F0), (N1, F1)
    exps = ref_basis_exponents(bg_spec)
    F0, F1 = U.shape[1], V.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    Ur = np.stack([np.roll(U, -l, axis=0) for l in range(-wx, wx + 1)], 1)
    Vr = np.stack([np.roll(V, -l, axis=0) for l in range(-wy, wy + 1)], 1)
    Ur = jnp.asarray(Ur.reshape(N0, R0 * F0).T)   # (R0*F0, N0)
    Vr = jnp.asarray(Vr.reshape(N1, R1 * F1).T)   # (R1*F1, N1)

    Fa = A.shape[0]
    A64 = A.astype(jnp.float64)
    # step 1 (y): M1[(e,t), (a,x)] = sum_y Vr[(e,t), y] A[a, x, y]
    M1 = _exact_skinny_matmul(Vr, jnp.transpose(A64, (2, 0, 1)).reshape(N1, -1))
    # step 2 (x): M2[(r,s), (e,t), a] = sum_x Ur[(r,s), x] M1[(e,t), (a,x)]
    M1 = M1.reshape(R1 * F1 * Fa, N0).T           # (N0, R1*F1*Fa)
    M2 = _exact_skinny_matmul(Ur, M1)             # (R0*F0, R1*F1*Fa)
    M2 = M2.reshape(R0, F0, R1, F1, Fa)
    out = jnp.stack([M2[:, i, :, j, :] for (i, j) in exps], axis=0)
    return jnp.transpose(out, (3, 0, 1, 2))       # (Fa, Fpq, R0, R1)


def _bg_roll_mats(bg_spec, N0, N1, wx, wy):
    from sfft_jax.core.basis import basis_1d_tables
    from sfft_jax.core.indices import ref_basis_exponents

    U, V = basis_1d_tables(bg_spec, N0, N1)
    exps = ref_basis_exponents(bg_spec)
    F0, F1 = U.shape[1], V.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    Ur = np.stack([np.roll(U, -l, axis=0) for l in range(-wx, wx + 1)], 1)
    Vr = np.stack([np.roll(V, -l, axis=0) for l in range(-wy, wy + 1)], 1)
    return (Ur.reshape(N0, R0 * F0), Vr.reshape(N1, R1 * F1),
            exps, F0, F1, R0, R1)


def exact_bg_corr_pair(Ap, bg_spec, N0: int, N1: int,
                       wx: int, wy: int) -> jnp.ndarray:
    """exact_bg_corr for a PAIR-represented real plane stack Ap (F, N0, N1):
    both contractions run through the sliced-integer exact dots — no f64
    elementwise. Returns (F, Fpq, R0, R1) f64."""
    from sfft_jax.core.exact_fft import CPair, _cmatmul_sliced

    Ur, Vr, exps, F0, F1, R0, R1 = _bg_roll_mats(bg_spec, N0, N1, wx, wy)
    # step 1 (y): contract last axis with Vr (N1, R1*F1)
    M1 = _cmatmul_sliced(Ap, Vr, None)               # pair (F, N0, R1*F1)
    M1t = CPair(jnp.swapaxes(M1.rh, -1, -2), jnp.swapaxes(M1.rl, -1, -2),
                None, None)                          # (F, R1*F1, N0)
    M2 = _cmatmul_sliced(M1t, Ur, None)              # pair (F, R1*F1, R0*F0)
    M = M2.rh.astype(jnp.float64) + M2.rl
    M = M.reshape(-1, R1, F1, R0, F0)
    out = jnp.stack([M[:, :, j, :, i] for (i, j) in exps], axis=1)
    return jnp.transpose(out, (0, 1, 3, 2))          # (F, Fpq, R0, R1)


def exact_plane_spectra(I: jnp.ndarray, J: jnp.ndarray, cfg):
    """Shared exact-engine front end: pair-split the images, build the
    basis-weighted pair planes [J, I*beta_ij (, I*sigma_ij)] in fused-f32 pair
    arithmetic, and take ONE half-spectrum pair-FFT of the whole stack.

    Both the Greek tables (greek_tables_exact) and the exact difference
    (fdiff_exact) consume this. The fused solve+subtract step computes it
    once per distinct (I, J) pair rather than relying on XLA CSE to dedupe
    the two textually-identical pipelines.

    Returns (Jp, SIp, SScp, sp): image-domain pairs (Jp one plane, SIp list
    of Fij, SScp list or None) and the stacked half spectra CPair in plane
    order [J] + SI (+ SSc)."""
    from sfft_jax.core.basis import basis_1d_tables
    from sfft_jax.core.exact_fft import (exact_sep_weighted_spectra,
                                         pair_from_f64, pair_sep_mul)
    from sfft_jax.core.indices import ref_basis_exponents

    N0, N1 = cfg.N0, cfg.N1
    Ip = pair_from_f64(I.astype(jnp.float64))
    Jp = pair_from_f64(J.astype(jnp.float64))
    Uk, Vk = basis_1d_tables(cfg.kernel_basis, N0, N1)
    exps_k = ref_basis_exponents(cfg.kernel_basis)
    # image-domain weighted planes (the GAM/PGS moment route consumes them)
    SIp = [pair_sep_mul(Ip, Uk[:, i], Vk[:, j]) for (i, j) in exps_k]
    Urows = [Uk[:, i] for (i, _j) in exps_k]
    Vrows = [Vk[:, j] for (_i, j) in exps_k]
    SScp = None
    if cfg.scaling_mode == "SEPARATE-VARYING":
        Us, Vs = basis_1d_tables(cfg.scaling_basis, N0, N1)
        exps_s = ref_basis_exponents(cfg.scaling_basis)
        SScp = [pair_sep_mul(Ip, Us[:, i], Vs[:, j]) for (i, j) in exps_s]
        Urows += [Us[:, i] for (i, _j) in exps_s]
        Vrows += [Vs[:, j] for (_i, j) in exps_s]
    # separable-weight pair-FFT with deduped axis-1 legs: Fi*Fj basis planes
    # share Fj distinct column factors (exact_sep_weighted_spectra)
    sp = exact_sep_weighted_spectra([Jp], Ip, np.stack(Urows),
                                    np.stack(Vrows))
    return Jp, SIp, SScp, sp


def greek_tables_exact(I: jnp.ndarray, J: jnp.ndarray, cfg, shared=None):
    """All exact-grade tables for one config, built WITHOUT f64 elementwise
    plane products: images are pair-split once, basis weightings run in
    fused-f32 pair arithmetic (pair_sep_mul), one pair-FFT covers every
    data plane (incl. SEPARATE-VARYING scaling planes), and background
    blocks use rolled-basis sliced moments.

    shared: optional precomputed exact_plane_spectra(I, J, cfg) output.

    Returns (Comg, Cgam, Cthe, Cphi, Cdel[, (Pbs, Pss, Pgs, Pts)])."""
    from sfft_jax.core.exact_fft import CPair, exact_corr_window, pair_stack

    N0, N1 = cfg.N0, cfg.N1
    w0, w1 = cfg.w0, cfg.w1
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    if shared is None:
        shared = exact_plane_spectra(I, J, cfg)
    Jp, SIp, SScp, sp = shared
    Fij = len(SIp)
    Fs = len(SScp) if SScp is not None else 0

    def sl(a, b):
        return CPair(sp.rh[a:b], sp.rl[a:b], sp.ih[a:b], sp.il[a:b])

    # ALL spectrum-pair windowed correlations share ONE pass: the
    # partial-iDFT lag grids pad to the same lane width (a 33-, 17- or
    # 1-lag output all pad to 64 dot columns), so every pair costs the same
    # at the widest (+-2w) window — OMG (SI x SI, +-2w), THE (SI x J, +-w)
    # and for SEPARATE-VARYING also PBS/PSS/PTS ride one call, saving the
    # per-call chunk-dispatch and 4 compiled programs (5 calls -> 1 on the
    # NIRCam B-spline config).
    iu, ju = np.triu_indices(Fij)
    ia_l = [iu + 1, np.arange(Fij) + 1]
    jb_l = [ju + 1, np.zeros(Fij, np.int64)]
    if separate_varying:
        gI, gS = np.meshgrid(np.arange(Fij) + 1,
                             np.arange(Fs) + 1 + Fij, indexing="ij")
        su, sv = np.triu_indices(Fs)
        ia_l += [gI.ravel(), su + 1 + Fij, np.arange(Fs) + 1 + Fij]
        jb_l += [gS.ravel(), sv + 1 + Fij, np.zeros(Fs, np.int64)]
    ia = np.concatenate(ia_l)
    jb = np.concatenate(jb_l)
    spec_all = sl(0, 1 + Fij + Fs)
    cc = exact_corr_window(spec_all, spec_all, N0, N1,
                           2 * w0, 2 * w1, pairs=(ia, jb))
    n_omg = len(iu)
    Comg = jnp.zeros((Fij, Fij, 4 * w0 + 1, 4 * w1 + 1), cc.dtype)
    Comg = Comg.at[iu, ju].set(cc[:n_omg])
    Comg = Comg.at[ju, iu].set(cc[:n_omg, ::-1, ::-1])
    Cthe = cc[n_omg : n_omg + Fij, w0 : 3 * w0 + 1, w1 : 3 * w1 + 1]
    SIstack = pair_stack(SIp)
    Cgam = exact_bg_corr_pair(SIstack, cfg.bg_basis, N0, N1, w0, w1)
    Cphi = jnp.asarray(bg_static_gram(cfg.bg_basis, N0, N1))
    Cdel = exact_bg_corr_pair(
        CPair(Jp.rh[None], Jp.rl[None], None, None),
        cfg.bg_basis, N0, N1, 0, 0)[0, :, 0, 0]
    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    o = n_omg + Fij
    Pbs = cc[o : o + Fij * Fs, w0 : 3 * w0 + 1, w1 : 3 * w1 + 1]
    Pbs = Pbs.reshape(Fij, Fs, 2 * w0 + 1, 2 * w1 + 1)
    o += Fij * Fs
    pss_u = cc[o : o + len(su), 2 * w0, 2 * w1]
    Pss = jnp.zeros((Fs, Fs), cc.dtype)
    Pss = Pss.at[su, sv].set(pss_u).at[sv, su].set(pss_u)
    o += len(su)
    Pts = cc[o : o + Fs, 2 * w0, 2 * w1]
    SScstack = pair_stack(SScp)
    Pgs = exact_bg_corr_pair(SScstack, cfg.bg_basis, N0, N1, 0, 0)[:, :, 0, 0]
    npad = cfg.Fij - Fs
    if npad:
        Pbs = jnp.pad(Pbs, ((0, 0), (0, npad), (0, 0), (0, 0)))
        Pss = jnp.pad(Pss, ((0, npad), (0, npad)))
        Pgs = jnp.pad(Pgs, ((0, npad), (0, 0)))
        Pts = jnp.pad(Pts, ((0, npad),))
    return Comg, Cgam, Cthe, Cphi, Cdel, (Pbs, Pss, Pgs, Pts)


def bg_static_gram(bg_spec, N0: int, N1: int) -> np.ndarray:
    """PHI block in closed form: <T_q, T_q'> = (sum_x u u') (sum_y v v') —
    separable exact host-side sums, zero device cost."""
    from sfft_jax.core.basis import basis_1d_tables
    from sfft_jax.core.indices import ref_basis_exponents

    U, V = basis_1d_tables(bg_spec, N0, N1)
    exps = ref_basis_exponents(bg_spec)
    GU = U.T @ U
    GV = V.T @ V
    return np.array([[GU[i1, i2] * GV[j1, j2] for (i2, j2) in exps]
                     for (i1, j1) in exps])


def greek_tables_separate(
    SI: jnp.ndarray,
    SSc: jnp.ndarray,
    ST: jnp.ndarray,
    J: jnp.ndarray,
    w0: int,
    w1: int,
    backend: str = "fft",
    chunk: int = 0,
    bg_spec=None,
    n_active: int = 0,
):
    """Extra correlation tables for SEPARATE-VARYING scaling: the center-offset
    dofs attach to the sigma-weighted stack SSc = I * sigma_ij (zero-padded to
    Fij planes; reference ScaSPixA_Iij, sfft/BSplineSFFT.py:2862-2886).

    Returns (Pbs_raw, Pss_raw, Pgs_raw, Pts_raw) unscaled CC tables:
      Pbs: CC(SI_a, SSc_b) window +-w; Pss: CC(SSc_a, SSc_b)[0];
      Pgs: CC(SSc_a, T_q)[0]; Pts: CC(SSc_a, J)[0].
    """
    N0, N1 = J.shape
    if backend == "exact":
        from sfft_jax.core.exact_fft import (CPair, exact_corr_window,
                                             exact_fft2_pair)

        Fij = SI.shape[0]
        Fs = n_active if n_active else SSc.shape[0]
        SScA = SSc[:Fs]   # trailing planes are static zero padding — skip
        stack = jnp.concatenate(
            [SI, SScA, J[None]], axis=0).astype(jnp.float64)
        sp = exact_fft2_pair(stack, half=True)
        specI = CPair(sp.rh[:Fij], sp.rl[:Fij], sp.ih[:Fij], sp.il[:Fij])
        specS = CPair(sp.rh[Fij:-1], sp.rl[Fij:-1], sp.ih[Fij:-1],
                      sp.il[Fij:-1])
        specJ = CPair(sp.rh[-1:], sp.rl[-1:], sp.ih[-1:], sp.il[-1:])
        Pbs = exact_corr_window(specI, specS, N0, N1, w0, w1)
        Pss = exact_corr_window(specS, specS, N0, N1, 0, 0,
                                symmetric=True)[:, :, 0, 0]
        Pts = exact_corr_window(specS, specJ, N0, N1, 0, 0)[:, 0, 0, 0]
        if bg_spec is not None:
            Pgs = exact_bg_corr(SScA, bg_spec, N0, N1, 0, 0)[:, :, 0, 0]
        else:
            spT = exact_fft2_pair(ST.astype(jnp.float64), half=True)
            specT = CPair(spT.rh, spT.rl, spT.ih, spT.il)
            Pgs = exact_corr_window(specS, specT, N0, N1, 0, 0)[:, :, 0, 0]
        npad = SSc.shape[0] - Fs
        if npad:
            Pbs = jnp.pad(Pbs, ((0, 0), (0, npad), (0, 0), (0, 0)))
            Pss = jnp.pad(Pss, ((0, npad), (0, npad)))
            Pgs = jnp.pad(Pgs, ((0, npad), (0, 0)))
            Pts = jnp.pad(Pts, ((0, npad),))
        return Pbs, Pss, Pgs, Pts
    Pss = dot_planes(SSc, SSc)
    Pgs = dot_planes(SSc, ST)
    Pts = dot_planes(SSc, J[None])[:, 0]
    if backend == "fft32":
        specI = jnp.fft.rfft2(SI.astype(jnp.float32))
        specS = jnp.fft.rfft2(SSc.astype(jnp.float32))
        Pbs = corr_window_fft(specI, specS, N0, N1, w0, w1, chunk=chunk)
        Pss = Pss.astype(jnp.float32)
        Pgs = Pgs.astype(jnp.float32)
        Pts = Pts.astype(jnp.float32)
    elif backend == "fft":
        specI = jnp.fft.rfft2(SI)
        specS = jnp.fft.rfft2(SSc)
        Pbs = corr_window_fft(specI, specS, N0, N1, w0, w1, chunk=chunk)
    elif backend == "corr":
        Pbs = corr_window_conv(SI, SSc, w0, w1)
    else:
        raise ValueError(backend)
    return Pbs, Pss, Pgs, Pts


def greek_tables(
    SI: jnp.ndarray,
    ST: jnp.ndarray,
    J: jnp.ndarray,
    w0: int,
    w1: int,
    backend: str = "fft",
    chunk: int = 0,
    bg_spec=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All correlation tables the assembly needs.

    Returns (Comg, Cgam, Cthe, Cphi, Cdel):
      Comg: (Fij, Fij, 4*w0+1, 4*w1+1)   lags -2w..2w, index lag+2w
      Cgam: (Fij, Fpq, 2*w0+1, 2*w1+1)   lags -w..w, index lag+w
            (the PSI table is its mirror: CC(T,I)[d] = CC(I,T)[-d])
      Cthe: (Fij, 2*w0+1, 2*w1+1)
      Cphi: (Fpq, Fpq) lag 0
      Cdel: (Fpq,)     lag 0

    Unscaled CC values; the engine applies the SCALE powers that map CC to the
    reference's Pre tables (PreOMG = SCALE^3 * CC, PreGAM/PSI/THE = SCALE^2 * CC,
    PrePHI/DEL = SCALE * CC; scales from sfft/sfftcore/SFFTSubtract.py:620-729).
    """
    N0, N1 = J.shape
    # Lag-zero blocks are plain inner products — never worth an FFT.
    Cphi = dot_planes(ST, ST)
    Cdel = dot_planes(ST, J[None])[:, 0]

    if backend == "fft32":
        # f32 compute, f32 tables (assembly runs in f32 too — halves the
        # peak device memory of the (Fij^2, Fab^2) assembly temporaries; the
        # engine casts the final assembled system to f64 for the solve).
        # Adequate for sky-subtracted data where correlations are
        # fluctuation-dominated; the f64 'fft' path is the contract.
        out32 = greek_tables(SI.astype(jnp.float32), ST.astype(jnp.float32),
                             J.astype(jnp.float32), w0, w1,
                             backend="fft", chunk=chunk)
        return out32[:3] + (Cphi.astype(jnp.float32), Cdel.astype(jnp.float32))

    if backend == "exact":
        # Exact-grade tables on hardware without f64 FFT: pair-arithmetic
        # sliced-integer FFT + windowed correlation (core/exact_fft.py) for
        # the data x data blocks, rolled-basis exact moments for everything
        # against the analytic background planes. Works for ANY spatial
        # basis (incl. dense-knot B-splines); tables accurate to ~1e-14
        # norm-wise, meeting the 1e-6 solution contract.
        from sfft_jax.core.exact_fft import (CPair, exact_corr_window,
                                             exact_fft2_pair)

        Fij = SI.shape[0]
        stack = jnp.concatenate([J[None], SI], axis=0).astype(jnp.float64)
        sp = exact_fft2_pair(stack, half=True)

        def sl(a, b):
            return CPair(sp.rh[a:b], sp.rl[a:b], sp.ih[a:b], sp.il[a:b])

        specJ = sl(0, 1)
        specI = sl(1, 1 + Fij)
        Comg = exact_corr_window(specI, specI, N0, N1, 2 * w0, 2 * w1,
                                 symmetric=True)
        Cthe = exact_corr_window(specI, specJ, N0, N1, w0, w1)[:, 0]
        if bg_spec is not None:
            Cgam = exact_bg_corr(SI, bg_spec, N0, N1, w0, w1)
            Cphi = jnp.asarray(bg_static_gram(bg_spec, N0, N1))
            Cdel = exact_bg_corr(J[None], bg_spec, N0, N1, 0, 0)[0, :, 0, 0]
        else:
            # no basis spec available (direct table calls): T planes through
            # the generic spectral route
            spT = exact_fft2_pair(ST.astype(jnp.float64), half=True)
            specT = CPair(spT.rh, spT.rl, spT.ih, spT.il)
            Cgam = exact_corr_window(specI, specT, N0, N1, w0, w1)
            Cphi = exact_corr_window(specT, specT, N0, N1, 0, 0,
                                     symmetric=True)[:, :, 0, 0]
            Cdel = exact_corr_window(specT, specJ, N0, N1, 0, 0)[:, 0, 0, 0]
        return Comg, Cgam, Cthe, Cphi, Cdel

    if backend == "fft":
        stack = jnp.concatenate([J[None], SI, ST], axis=0)
        specs = jnp.fft.rfft2(stack)
        Fij = SI.shape[0]
        specJ = specs[0:1]
        specI = specs[1 : 1 + Fij]
        specT = specs[1 + Fij :]
        Comg = corr_window_fft(specI, specI, N0, N1, 2 * w0, 2 * w1,
                               chunk=chunk, symmetric=True)
        Cgam = corr_window_fft(specI, specT, N0, N1, w0, w1, chunk=chunk)
        Cthe = corr_window_fft(specI, specJ, N0, N1, w0, w1, chunk=chunk)[:, 0]
    elif backend == "corr":
        Comg = corr_window_conv(SI, SI, 2 * w0, 2 * w1)
        Cgam = corr_window_conv(SI, ST, w0, w1)
        Cthe = corr_window_conv(SI, J[None], w0, w1)[:, 0]
    else:
        raise ValueError(f"unknown greek backend {backend!r}")
    return Comg, Cgam, Cthe, Cphi, Cdel
