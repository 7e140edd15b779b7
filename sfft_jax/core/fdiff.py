"""Difference-image construction from a solved coefficient vector.

Reference: Kab phase factors + Construct_FDIFF + ifft2
(sfft/sfftcore/SFFTSubtract.py:771-816, sfft/sfftcore/SFFTConfigure.py:734-809).
The reference evaluates, per output pixel, a sum over all Fij*Fab terms with
per-pixel phase products W_l^a W_m^b. Two reformulations:

'fft' backend — the phase sum factorizes: the per-ij kernel spectrum is
    K_ij[u, v] = sum_ab A[ij, a, b] W_u^a W_v^b = (W0 @ A_ij @ W1)[u, v],
two skinny matmuls (N0 x L0 and L1 x N1h) instead of a per-pixel loop, and
everything runs on half-spectra (all factors are Hermitian — the reference
does full complex FFTs and takes .real at the end).

'conv' backend — complex-free: in the delta basis, multiplying by (W^a W^b - 1)
is shift-minus-identity, so the model is a circular convolution with the
*standard-basis* kernel (center coefficient 2*a_ij00 - sum_ab a_ijab — exactly
the SVKDict_SFFT2ST conversion, sfft/utils/SFFTSolutionReader.py:102-114):
    D = J - SCALE * sum_ij circconv(I * beta_ij, Astd_ij) - sum_pq b_pq T_pq.
This runs as a grouped lax.conv on wrap-padded planes, with no complex
arithmetic at all.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig


def _phase_matrices(cfg: SFFTConfig, half: bool = True):
    """W0[u, a] = exp(-2i pi u a / N0) for a in [-w0, w0]; W1[b, v] likewise.

    Static numpy constants (complex128 on CPU-style dtypes, complex64 for f32).
    """
    N0, N1 = cfg.N0, cfg.N1
    a = np.arange(-cfg.w0, cfg.w0 + 1)
    b = np.arange(-cfg.w1, cfg.w1 + 1)
    u = np.arange(N0)
    v = np.arange(N1 // 2 + 1 if half else N1)
    W0 = np.exp((-2j * np.pi / N0) * np.outer(u, a))
    W1 = np.exp((-2j * np.pi / N1) * np.outer(b, v))
    cdt = np.complex128 if cfg.dtype == "float64" else np.complex64
    return W0.astype(cdt), W1.astype(cdt)


def split_solution(cfg: SFFTConfig, solution: jnp.ndarray):
    a_ijab = solution[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1)
    b_pq = solution[cfg.Fijab :]
    return a_ijab, b_pq


def standard_kernel_coeffs(cfg: SFFTConfig, a_ijab: jnp.ndarray) -> jnp.ndarray:
    """delta-basis -> standard Cartesian-basis kernel coefficients:
    center pixel becomes 2*a_00 - sum(a) (sfft/utils/SFFTSolutionReader.py:102-114)."""
    s = jnp.sum(a_ijab, axis=(1, 2))
    center = 2.0 * a_ijab[:, cfg.w0, cfg.w1] - s
    return a_ijab.at[:, cfg.w0, cfg.w1].set(center)


def fdiff_fft(
    cfg: SFFTConfig,
    solution: jnp.ndarray,
    SI: jnp.ndarray,
    ST: jnp.ndarray,
    J: jnp.ndarray,
    SSc: jnp.ndarray = None,
) -> jnp.ndarray:
    """Fourier-space difference: D = irfft2(FJ - sum_ij K_ij . FI_ij - sum b FT).

    SSc: scaling-weighted planes (SEPARATE-VARYING); the center-offset dofs
    apply to them instead of SI (reference Construct_FDIFF SEPARATE-VARYING
    variant, sfft/BSplineSFFT.py:2430-2528). The non-center kernel spectrum is
    built center-zeroed; the center contribution is a flat SCALE * a00 factor
    on the sigma planes (equivalent to the reference's per-pixel branch)."""
    N0, N1 = cfg.N0, cfg.N1
    a_ijab, b_pq = split_solution(cfg, solution)
    W0, W1 = _phase_matrices(cfg, half=True)
    W0 = jnp.asarray(W0)
    W1 = jnp.asarray(W1)
    cdt = W0.dtype

    stack = jnp.concatenate([J[None], SI, ST], axis=0)
    specs = jnp.fft.rfft2(stack)
    FJ = specs[0]
    FI = specs[1 : 1 + cfg.Fij]
    FT = specs[1 + cfg.Fij :]

    a00 = a_ijab[:, cfg.w0, cfg.w1]
    Ap = a_ijab.at[:, cfg.w0, cfg.w1].set(0.0).astype(cdt)
    # K'_ij[u, v] = (W0 @ A'_ij @ W1)[u, v]  (center-zeroed kernel spectrum)
    K = jnp.einsum("ua,iab,bv->iuv", W0, Ap, W1, precision=lax.Precision.HIGHEST)
    s_nc = jnp.sum(a_ijab, axis=(1, 2)) - a00
    factor = cfg.SCALE * (K - s_nc.astype(cdt)[:, None, None])

    model = jnp.sum(factor * FI, axis=0) + jnp.tensordot(b_pq.astype(cdt), FT, axes=(0, 0))
    if SSc is None:
        model = model + cfg.SCALE * jnp.tensordot(a00.astype(cdt), FI, axes=(0, 0))
    else:
        FS = jnp.fft.rfft2(SSc)
        model = model + cfg.SCALE * jnp.tensordot(a00.astype(cdt), FS, axes=(0, 0))
    FDIFF = FJ - model
    return jnp.fft.irfft2(FDIFF, s=(N0, N1)).astype(J.dtype)


def fdiff_conv(
    cfg: SFFTConfig,
    solution: jnp.ndarray,
    SI: jnp.ndarray,
    ST: jnp.ndarray,
    J: jnp.ndarray,
    SSc: jnp.ndarray = None,
) -> jnp.ndarray:
    """Real-space circular-convolution difference (complex-free)."""
    a_ijab, b_pq = split_solution(cfg, solution)
    if SSc is not None:
        # SEPARATE-VARYING: non-center offsets act on SI with an effective
        # center -(sum - a00); the a00 dofs act flat on the sigma planes.
        a00 = a_ijab[:, cfg.w0, cfg.w1]
        Astd = a_ijab.at[:, cfg.w0, cfg.w1].set(
            -(jnp.sum(a_ijab, axis=(1, 2)) - a00)
        )
        extra = cfg.SCALE * jnp.tensordot(a00, SSc, axes=(0, 0))
    else:
        Astd = standard_kernel_coeffs(cfg, a_ijab)
        extra = 0.0
    w0, w1 = cfg.w0, cfg.w1
    # circular convolution: out[x] = sum_ab k[a, b] * in[x - a, y - b]
    # lax.conv computes correlation, so flip the kernel.
    kflip = Astd[:, ::-1, ::-1]
    SIpad = jnp.pad(SI, ((0, 0), (w0, w0), (w1, w1)), mode="wrap")
    conv = lax.conv_general_dilated(
        SIpad[None],  # (1, Fij, H, W)
        kflip[:, None],  # (Fij, 1, L0, L1)
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=cfg.Fij,
        precision=lax.Precision.HIGHEST,
    )[0]
    model = (
        cfg.SCALE * jnp.sum(conv, axis=0)
        + jnp.tensordot(b_pq, ST, axes=(0, 0))
        + extra
    )
    return J - model


def fdiff_exact(
    cfg: SFFTConfig,
    solution: jnp.ndarray,
    I: jnp.ndarray,
    J: jnp.ndarray,
    shared=None,
) -> jnp.ndarray:
    """Exact-grade (double-float) difference construction without f64 FFTs.

    Same spectral algebra as fdiff_fft, carried in f32-pair arithmetic with
    the sliced-integer exact transforms of core/exact_fft.py: the fft32
    route's ~2e-4 RMS deviation from the f64 oracle (measured) breaks the
    1e-6 diff contract once the solve itself is exact. Pieces:
      * forward half-spectra of J, SI (and SSc) via exact_fft2_pair — when
        the masked and unmasked inputs coincide, XLA CSEs these with the
        solve's spectra;
      * per-ij kernel spectra K = W0 @ A_ij @ W1 as two sliced matmuls
        against the static phase matrices;
      * model spectrum as compensated pair Hadamard sums;
      * the background term exactly in image space (separable U B V^T);
      * inverse transform of the Hermitian half with weight-2 fold, again
        through the exact pair DFT (zero-extended k1 axis).

    shared: optional precomputed exact_plane_spectra(I, J, cfg) output; the
    engine passes the solve's spectra through when the masked and unmasked
    pairs coincide (one pair-FFT instead of two — XLA's CSE does NOT dedupe
    the two pipelines reliably).
    """
    from sfft_jax.core.exact_fft import (CPair, _cmatmul_sliced,
                                         _pair_hadamard_conj, _two_sum,
                                         exact_dft_axis, pair_from_f64)
    from sfft_jax.core.greek import exact_plane_spectra

    N0, N1 = cfg.N0, cfg.N1
    N1h = N1 // 2 + 1
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    a_ijab, b_pq = split_solution(cfg, solution)
    W0, W1 = _phase_matrices(cfg, half=True)   # (N0, L0), (L1, N1h) c128

    if shared is None:
        shared = exact_plane_spectra(I, J, cfg)
    _Jp, _SIp, _SScp, sp = shared
    nss = len(_SScp) if _SScp is not None else 0

    def sl(a, b):
        return CPair(sp.rh[a:b], sp.rl[a:b], sp.ih[a:b], sp.il[a:b])

    FJ = sl(0, 1)
    FI = sl(1, 1 + cfg.Fij)
    FS = sl(1 + cfg.Fij, 1 + cfg.Fij + nss) if separate_varying else None

    # --- kernel spectra K_ij = W0 @ A'_ij @ W1 (center-zeroed) -------------
    a00 = a_ijab[:, cfg.w0, cfg.w1]
    Ap = a_ijab.at[:, cfg.w0, cfg.w1].set(0.0)
    # T1[i, b, u] = sum_a Ap[i, a, b] W0[u, a]
    Adat = pair_from_f64(jnp.swapaxes(Ap, 1, 2))           # (i, b, a)
    T1 = _cmatmul_sliced(Adat, W0.real.T.copy(), W0.imag.T.copy())
    # K[i, u, v] = sum_b T1[i, b, u] W1[b, v] -> layout (i, u, b) contract b
    T1m = CPair(*(None if v is None else jnp.swapaxes(v, -1, -2) for v in T1))
    K = _cmatmul_sliced(T1m, W1.real.copy(), W1.imag.copy())   # (i, u, v)

    # --- model spectrum: compensated pair sum over ij ----------------------
    # per-ij spectral factor (reference Construct_FDIFF): for the ENTANGLED
    # center dof the delta-basis term is a00 * 1, so the combined factor is
    # K'[u,v] + (a00 - s_nc); SEPARATE-VARYING applies a00 to the FS planes.
    s_nc = jnp.sum(a_ijab, axis=(1, 2)) - a00

    def shift_pair(P, c):
        """pair + f64 scalar, compensated."""
        c32 = c.astype(jnp.float32)
        cres = (c - c32.astype(jnp.float64)).astype(jnp.float32)
        h, e = _two_sum(P.rh, jnp.broadcast_to(c32, P.rh.shape))
        return CPair(h, P.rl + e + cres, P.ih, P.il)

    def scale_pair(P, c):
        """pair * f64 scalar, compensated (TwoProd on the hi lane)."""
        from sfft_jax.core.exact_fft import _two_prod

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
    for i in range(cfg.Fij):
        c_i = (a00[i] - s_nc[i]) if FS is None else -s_nc[i]
        Ki = shift_pair(CPair(K.rh[i], K.rl[i], K.ih[i], K.il[i]), c_i)
        FIi = CPair(FI.rh[i], FI.rl[i], FI.ih[i], FI.il[i])
        # hadamard computes A * conj(B); pass conj(K) to get A * K
        H = _pair_hadamard_conj(FIi, CPair(Ki.rh, Ki.rl, -Ki.ih, -Ki.il))
        acc = addp(acc, H)
    if FS is not None:
        for i in range(nss):
            FSi = CPair(FS.rh[i], FS.rl[i], FS.ih[i], FS.il[i])
            acc = addp(acc, scale_pair(FSi, a00[i]))

    # FDIFF = FJ - SCALE * acc  (SCALE = 1/(N0*N1) is not a power of two in
    # general — apply it with a compensated scalar product)
    m = scale_pair(CPair(acc[0], acc[1], acc[2], acc[3]),
                   jnp.float64(cfg.SCALE))
    dr, er = _two_sum(FJ.rh[0], -m.rh)
    di, ei = _two_sum(FJ.ih[0], -m.ih)
    FD = CPair(dr, FJ.rl[0] - m.rl + er,
               di, FJ.il[0] - m.il + ei)

    # --- inverse transform of the Hermitian half ---------------------------
    # Axis order matters: run the axis-0 inverse FIRST, while the spectrum
    # still has only N1h = N1/2+1 columns (half the work of a full-width
    # axis), then the axis-1 inverse with the Hermitian fold (weight-2
    # interior columns; valid because Z[x, N1-v] = conj(Z[x, v]) after the
    # axis-0 transform of a real-image spectrum) asking for the REAL part
    # only — the final butterfly stage then skips its two cross dots.
    fold = np.full(N1h, 2.0)
    fold[0] = 1.0
    if N1 % 2 == 0:
        fold[-1] = 1.0
    foldj = jnp.asarray(fold, jnp.float32)
    FDw = CPair(FD.rh * foldj, FD.rl * foldj, FD.ih * foldj, FD.il * foldj)

    def mv(v):
        return None if v is None else jnp.swapaxes(v, -1, -2)

    zt = exact_dft_axis(CPair(mv(FDw.rh), mv(FDw.rl), mv(FDw.ih),
                              mv(FDw.il)), N0, inverse=True)   # (N1h, N0)
    z = CPair(mv(zt.rh), mv(zt.rl), mv(zt.ih), mv(zt.il))      # (N0, N1h)
    if N1 % 2 == 0:
        # half-input real inverse: no zero-pad to full width, half the
        # stage-1 slicing traffic (exact_fft.exact_idft_halfin_real)
        from sfft_jax.core.exact_fft import exact_idft_halfin_real

        y = exact_idft_halfin_real(z, N1)
    else:
        pad = N1 - N1h
        zp = CPair(*(None if v is None else jnp.pad(v, ((0, 0), (0, pad)))
                     for v in z))
        y = exact_dft_axis(zp, N1, inverse=True, real_out=True)
    D = (y.rh.astype(jnp.float64) + y.rl) / (N0 * N1)

    # --- background term, exactly, in image space --------------------------
    from sfft_jax.core.basis import basis_1d_tables
    from sfft_jax.core.indices import ref_basis_exponents

    U, V = basis_1d_tables(cfg.bg_basis, N0, N1)
    exps = ref_basis_exponents(cfg.bg_basis)
    B = jnp.zeros((U.shape[1], V.shape[1]), jnp.float64)
    B = B.at[exps[:, 0], exps[:, 1]].add(b_pq)
    bgplane = jnp.einsum("xs,st,yt->xy", jnp.asarray(U), B, jnp.asarray(V),
                         precision=lax.Precision.HIGHEST)
    return (D - bgplane).astype(J.dtype)


def fdiff(cfg: SFFTConfig, solution, SI, ST, J, SSc=None, I=None,
          shared=None) -> jnp.ndarray:
    if cfg.fdiff_backend == "exact":
        assert I is not None, "fdiff_exact needs the unmasked image I"
        return fdiff_exact(cfg, solution, I, J, shared=shared)
    if cfg.fdiff_backend == "pexact":
        from sfft_jax.core.pexact import fdiff_pexact

        assert I is not None, "fdiff_pexact needs the unmasked image I"
        return fdiff_pexact(cfg, solution, I, J, shared=shared)
    if cfg.fdiff_backend == "fft":
        return fdiff_fft(cfg, solution, SI, ST, J, SSc)
    if cfg.fdiff_backend == "conv":
        return fdiff_conv(cfg, solution, SI, ST, J, SSc)
    if cfg.fdiff_backend == "fft32":
        # float32/complex64 compute, float64-held solution. Absolute error
        # ~1e-7 * |J| — far below the pixel noise for astronomical data; the
        # exact path is fdiff_fft in f64.
        import dataclasses

        cfg32 = dataclasses.replace(cfg, dtype="float32", fdiff_backend="fft")
        out = fdiff_fft(
            cfg32,
            solution.astype(jnp.float32),
            SI.astype(jnp.float32),
            ST.astype(jnp.float32),
            J.astype(jnp.float32),
            None if SSc is None else SSc.astype(jnp.float32),
        )
        return out.astype(J.dtype)
    raise ValueError(f"unknown fdiff backend {cfg.fdiff_backend!r}")
