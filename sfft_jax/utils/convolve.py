"""2D convolution utilities with astronomy-standard boundary semantics.

Equivalent of the astropy.convolution.convolve usage throughout the reference
(e.g. test/difference_noise_decorrelation/decorr.py, BSpline_GridConvolve):
direct convolution with 'extend' / 'fill' boundaries, optional kernel
normalization and NaN interpolation. Implemented with jax.lax.conv and a
numpy fallback.
"""

from __future__ import annotations

import numpy as np


def _pad(arr: np.ndarray, w0: int, w1: int, boundary: str, fill_value: float):
    if boundary == "extend":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="edge")
    if boundary == "fill":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="constant", constant_values=fill_value)
    if boundary == "wrap":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="wrap")
    raise ValueError(boundary)


def convolve2d(
    image: np.ndarray,
    kernel: np.ndarray,
    boundary: str = "extend",
    fill_value: float = 0.0,
    normalize_kernel: bool = False,
    nan_treatment: str = "interpolate",
    use_jax: bool = True,
) -> np.ndarray:
    """astropy-convolve-compatible direct convolution.

    out[x, y] = sum_ab k[a, b] * in[x - (a - w0), y - (b - w1)]  — i.e. the
    kernel is centered and *convolved* (flipped), matching astropy. NaNs in the
    input are replaced by the kernel-weighted average of their neighborhood
    ('interpolate', astropy's default) or by zero ('fill').
    """
    image = np.asarray(image, dtype=np.float64)
    kernel = np.asarray(kernel, dtype=np.float64)
    L0, L1 = kernel.shape
    assert L0 % 2 == 1 and L1 % 2 == 1
    w0, w1 = L0 // 2, L1 // 2

    ksum = kernel.sum()
    kwork = kernel / ksum if normalize_kernel else kernel

    nanmask = ~np.isfinite(image)
    any_nan = bool(nanmask.any())
    img = np.where(nanmask, 0.0, image) if any_nan else image

    def _conv(x):
        xp = _pad(x, w0, w1, boundary, fill_value)
        if use_jax:
            import jax.numpy as jnp
            import jax.lax as lax

            out = lax.conv_general_dilated(
                jnp.asarray(xp)[None, None],
                jnp.asarray(kwork[::-1, ::-1])[None, None],
                (1, 1), "VALID",
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                precision=lax.Precision.HIGHEST,
            )
            return np.asarray(out[0, 0])
        # numpy fallback (small images)
        out = np.zeros_like(x)
        for a in range(L0):
            for b in range(L1):
                out += kwork[a, b] * xp[L0 - 1 - a : L0 - 1 - a + x.shape[0],
                                        L1 - 1 - b : L1 - 1 - b + x.shape[1]]
        return out

    if any_nan and nan_treatment == "interpolate":
        # astropy-style: convolve data*mask and mask, divide
        good = (~nanmask).astype(np.float64)
        num = _conv(img)
        den = _conv_mask(good, kwork, w0, w1, boundary, use_jax)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = num / den
        if not normalize_kernel:
            out = out * ksum if abs(ksum) > 0 else out
        # astropy keeps result where den > 0
        out = np.where(den > 0, out, np.nan)
        return out

    out = _conv(img)
    return out


def _conv_mask(mask, kwork, w0, w1, boundary, use_jax):
    # normalized-kernel convolution of the validity mask
    k = kwork / kwork.sum() if abs(kwork.sum()) > 0 else kwork
    maskp = _pad(mask, w0, w1, boundary, 0.0)
    if use_jax:
        import jax.numpy as jnp
        import jax.lax as lax

        out = lax.conv_general_dilated(
            jnp.asarray(maskp)[None, None],
            jnp.asarray(k[::-1, ::-1])[None, None],
            (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=lax.Precision.HIGHEST,
        )
        return np.asarray(out[0, 0])
    L0, L1 = k.shape
    out = np.zeros_like(mask)
    for a in range(L0):
        for b in range(L1):
            out += k[a, b] * maskp[L0 - 1 - a : L0 - 1 - a + mask.shape[0],
                                   L1 - 1 - b : L1 - 1 - b + mask.shape[1]]
    return out
