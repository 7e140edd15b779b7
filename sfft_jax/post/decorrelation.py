"""Difference-image noise decorrelation kernels.

After PSF matching, the difference D = J - I (*) K has spatially correlated
noise (the convolution correlates I's noise). The decorrelation kernel whitens
it: in Fourier space  F_deco = 1 / sqrt( sum_j s_j^2 |F(K_j)|^2 / Nj^2
+ sum_i s_i^2 |F(K_i)|^2 |F(K_fin)|^2 / Ni^2 ), supporting image-stacking
(J group only) and image-subtraction (J group vs I group through a final
matching kernel) modes.

Reference implementations unified here: DeCorrelation_Calculator.DCC
(sfft/utils/DeCorrelationCalculator.py), PureCupy_DeCorrelation_Calculator.PCDC
(sfft/utils/PureCupyDeCorrelationCalculator.py, with REAL_OUTPUT /
NORMALIZE_OUTPUT / clipping options), and BSpline_DeCorrelation.BDC
(sfft/BSplineSFFT.py:4755-4868, with DENO_CLIP_RATIO denominator clipping).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sfft_jax.post.fftkits import kernel_csz, kernel_csz_inv

_DELTA3 = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)


def _kpow2(kernel: Optional[np.ndarray], N0: int, N1: int, xp) -> np.ndarray:
    k = _DELTA3 if kernel is None else kernel
    kimg = kernel_csz(xp.asarray(k, dtype=np.float64), N0, N1)
    if xp is np:
        kft = np.fft.fft2(kimg)
    else:
        import jax.numpy as jnp

        kft = jnp.fft.fft2(kimg.astype(jnp.complex128 if kimg.dtype == np.float64 else None))
    return (xp.conj(kft) * kft).real


def decorrelation_denominator(
    MK_JLst: Sequence[Optional[np.ndarray]],
    SkySig_JLst: Sequence[float],
    MK_ILst: Sequence[Optional[np.ndarray]] = (),
    SkySig_ILst: Sequence[float] = (),
    MK_Fin: Optional[np.ndarray] = None,
    N0: int = 64,
    N1: int = 64,
    xp=np,
) -> np.ndarray:
    NumI, NumJ = len(MK_ILst), len(MK_JLst)
    deno = xp.zeros((N0, N1), dtype=np.float64)
    for mk, s in zip(MK_JLst, SkySig_JLst):
        deno = deno + (s**2) * _kpow2(mk, N0, N1, xp) / NumJ**2
    if NumI >= 1:
        kfin2 = _kpow2(MK_Fin, N0, N1, xp)
        for mk, s in zip(MK_ILst, SkySig_ILst):
            deno = deno + (s**2) * _kpow2(mk, N0, N1, xp) * kfin2 / NumI**2
    return deno


def decorrelation_kernel(
    MK_JLst: Sequence[Optional[np.ndarray]],
    SkySig_JLst: Sequence[float],
    MK_ILst: Sequence[Optional[np.ndarray]] = (),
    SkySig_ILst: Sequence[float] = (),
    MK_Fin: Optional[np.ndarray] = None,
    KERatio: float = 2.0,
    VERBOSE_LEVEL: int = 1,
    DENO_CLIP_RATIO: Optional[float] = None,
) -> np.ndarray:
    """Reference DeCorrelation_Calculator.DCC: real-space decorrelation kernel,
    truncated to KERatio x (max matching-kernel size), unit-sum normalized.

    Image-stacking mode: no I list (needs >= 2 J kernels). Image-subtraction
    mode: both lists (+ optional final matching kernel).

    DENO_CLIP_RATIO: floor tiny denominator values at max/ratio before the
    square root — BSpline_DeCorrelation.BDC behavior (the reference's B-spline
    variant clips at 1e5 by default, sfft/BSplineSFFT.py:4853-4857, because
    near-zero denominator pixels blow up the whitening kernel on JWST data);
    the plain DCC reference never clips, hence default None here."""
    NumI, NumJ = len(MK_ILst), len(MK_JLst)
    if NumI == 0:
        if NumJ < 2:
            raise ValueError("Image-Stacking mode requires at least 2 J-images")
        if not any(mk is not None for mk in MK_JLst):
            raise ValueError("Image-Stacking mode requires a non-None J-kernel")
    else:
        if NumJ == 0:
            raise ValueError("Image-Subtraction mode requires >= 1 I & J image")
        if not any(mk is not None for mk in list(MK_JLst) + list(MK_ILst) + [MK_Fin]):
            raise ValueError("need at least one non-None kernel")

    queue = [mk for mk in list(MK_JLst) + ([MK_Fin] + list(MK_ILst) if NumI else [])
             if mk is not None]
    L0 = int(round(KERatio * max(mk.shape[0] for mk in queue)))
    L1 = int(round(KERatio * max(mk.shape[1] for mk in queue)))
    L0 += 1 - L0 % 2
    L1 += 1 - L1 % 2
    if VERBOSE_LEVEL in (1, 2):
        print(f"MeLOn CheckPoint: DeCorrelation Kernel with size [{L0}, {L1}]")

    N0 = 2 ** (math.ceil(np.log2(max(mk.shape[0] for mk in queue))) + 1)
    N1 = 2 ** (math.ceil(np.log2(max(mk.shape[1] for mk in queue))) + 1)

    deno = decorrelation_denominator(
        MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, N0, N1, np
    )
    if DENO_CLIP_RATIO is not None:
        if VERBOSE_LEVEL == 2:
            print(f"MeLOn CheckPoint: Initial Max/Min "
                  f"[{np.max(deno)/np.min(deno):.1f}] in Denominator Map")
        floor = np.max(deno) / DENO_CLIP_RATIO
        clip_mask = deno < floor
        deno = np.where(clip_mask, floor, deno)
        if VERBOSE_LEVEL == 2:
            print(f"MeLOn CheckPoint: DENOMINATOR CLIPPING TWEAKED "
                  f"[{clip_mask.mean():.2%}] PIXELS")
    # with clipping disabled (DENO_CLIP_RATIO=None) spectral zeros in the
    # denominator legitimately propagate inf/NaN into the kernel — that IS
    # the documented failure mode the clipping exists to prevent
    # (reference default DENO_CLIP_RATIO=1e5); don't warn about it. With
    # clipping ON the denominator is floored strictly positive, so any
    # divide/invalid there would signal NaN-contaminated input kernels —
    # keep the warning live in that branch.
    with np.errstate(**(dict(divide="ignore", invalid="ignore")
                        if DENO_CLIP_RATIO is None else {})):
        fdeco = np.sqrt(1.0 / deno)
        deco = np.fft.ifft2(fdeco).real
    kdeco, _ = kernel_csz_inv(deco, L0, L1, verbose=VERBOSE_LEVEL == 2)
    return kdeco / np.sum(kdeco)


def decorrelation_transfer(
    NX_IMG: int,
    NY_IMG: int,
    KERNEL_JQueue: Sequence[Optional[np.ndarray]],
    BKGSIG_JQueue: Sequence[float],
    KERNEL_IQueue: Sequence[Optional[np.ndarray]] = (),
    BKGSIG_IQueue: Sequence[float] = (),
    MATCH_KERNEL: Optional[np.ndarray] = None,
    REAL_OUTPUT: bool = False,
    REAL_OUTPUT_SIZE: Optional[Tuple[int, int]] = None,
    NORMALIZE_OUTPUT: bool = True,
    DENO_CLIP_RATIO: Optional[float] = None,
    VERBOSE_LEVEL: int = 1,
    xp=np,
):
    """Full-image-size decorrelation (reference PCDC + BDC clipping):
    returns the Fourier transfer map F_deco (REAL_OUTPUT=False, normalized so
    F_deco[0,0] = 1) or a truncated real-space kernel.

    DENO_CLIP_RATIO: clip tiny denominator values at max/ratio before the
    square root (BSpline_DeCorrelation behavior) to avoid blow-up."""
    deno = decorrelation_denominator(
        KERNEL_JQueue, BKGSIG_JQueue, KERNEL_IQueue, BKGSIG_IQueue,
        MATCH_KERNEL, NX_IMG, NY_IMG, xp,
    )
    if DENO_CLIP_RATIO is not None:
        floor = xp.max(deno) / DENO_CLIP_RATIO
        deno = xp.where(deno < floor, floor, deno)
    # same unclipped spectral-zero failure mode as decorrelation_kernel:
    # suppress the expected divide/invalid warning only for the numpy path
    # with clipping off (jax doesn't emit numpy warnings inside jit anyway)
    if xp is np and DENO_CLIP_RATIO is None:
        with np.errstate(divide="ignore", invalid="ignore"):
            fdeco = 1.0 / np.sqrt(deno)
    else:
        fdeco = 1.0 / xp.sqrt(deno)

    if not REAL_OUTPUT:
        if NORMALIZE_OUTPUT:
            fdeco = fdeco / fdeco[0, 0]
        return fdeco

    if xp is np:
        kdeco_img = np.fft.ifft2(fdeco).real
    else:
        import jax.numpy as jnp

        kdeco_img = jnp.fft.ifft2(fdeco).real
    assert REAL_OUTPUT_SIZE is not None
    kdeco, _ = kernel_csz_inv(kdeco_img, *REAL_OUTPUT_SIZE, verbose=VERBOSE_LEVEL == 2)
    if NORMALIZE_OUTPUT:
        kdeco = kdeco / xp.sum(kdeco)
    return kdeco


class DeCorrelationCalculator:
    """Reference-compatible facade (DCC) — no denominator clipping."""

    @staticmethod
    def DCC(MK_JLst, SkySig_JLst, MK_ILst=[], SkySig_ILst=[], MK_Fin=None,
            KERatio=2.0, VERBOSE_LEVEL=1):
        return decorrelation_kernel(
            MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, KERatio, VERBOSE_LEVEL
        )


class BSplineDeCorrelation:
    """Reference-compatible facade (BSpline_DeCorrelation.BDC,
    sfft/BSplineSFFT.py:4755-4868): same math as DCC plus denominator
    clipping at max/DENO_CLIP_RATIO (default 1e5, like the reference) so
    near-zero Fourier denominator pixels cannot blow up the whitening
    kernel (observed on JWST/NIRCam data)."""

    @staticmethod
    def BDC(MK_JLst, SkySig_JLst, MK_ILst=[], SkySig_ILst=[], MK_Fin=None,
            KERatio=2.0, DENO_CLIP_RATIO=100000.0, VERBOSE_LEVEL=1):
        return decorrelation_kernel(
            MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, KERatio,
            VERBOSE_LEVEL, DENO_CLIP_RATIO=DENO_CLIP_RATIO
        )
