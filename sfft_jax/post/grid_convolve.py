"""Grid-wise spatially-varying convolution.

Reference: BSpline_GridConvolve (sfft/BSplineSFFT.py:4870-5008) — label map ->
per-tile extended cutout -> convolve -> stitch, parallelized with a process
pool (CPU) or a python loop of cupy convolutions (GPU).

Design: for the (typical) uniform tile grid, all tiles are the same
shape, so the whole operation is ONE batched lax.conv over a stack of
halo-extended tiles — no loops, no process pool; XLA pipelines the tile
extraction (gather) into the convolution. An arbitrary label map falls back to
a python loop with the same per-segment semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_tile_grid(N0: int, N1: int, TiHW: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform tile allocation exactly as the reference's canonical example
    (sfft/BSplineSFFT.py:4884-4899): tile size TiN = 2*TiHW+1, raster labels.
    Returns (AllocatedL (N0, N1) int labels, XY_TiC (Nseg, 2) tile centers in
    FortranCoor)."""
    TiN = 2 * TiHW + 1
    lab = 0
    AllocatedL = np.zeros((N0, N1), dtype=int)
    XY_TiC = []
    for xs in np.arange(0, N0, TiN):
        xe = min(xs + TiN, N0)
        for ys in np.arange(0, N1, TiN):
            ye = min(ys + TiN, N1)
            AllocatedL[xs:xe, ys:ye] = lab
            XY_TiC.append([0.5 + xs + (xe - xs) / 2.0, 0.5 + ys + (ye - ys) / 2.0])
            lab += 1
    return AllocatedL, np.array(XY_TiC)


def grid_convolve_uniform(
    image: np.ndarray,
    ker_stack: np.ndarray,
    TiHW: int,
    nan_fill_value: float = 0.0,
    normalize_kernel: bool = True,
    use_fft: Optional[bool] = None,
) -> np.ndarray:
    """Spatially-varying convolution on a uniform tile grid, fully batched.

    ker_stack: (Nseg, L0, L1) with Nseg = ntx * nty raster tiles (the
    make_tile_grid ordering). Border tiles may be smaller than TiN; they are
    handled by padding the image to a full tile multiple (zero fill — matching
    the reference's boundary='fill' cutout convolution).

    Two batched paths (vs. the reference's per-tile python loops):
      direct — ONE grouped lax.conv over the halo-tile stack (small kernels)
      fft    — ONE batched rfft2 convolution over zero-padded halo tiles
               (large kernels, e.g. 400-px decorrelation kernels)
    use_fft=None picks by kernel area.
    """
    import jax
    import jax.lax as lax
    import jax.numpy as jnp

    N0, N1 = image.shape
    Nseg, L0, L1 = ker_stack.shape
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    TiN = 2 * TiHW + 1
    ntx = -(-N0 // TiN)
    nty = -(-N1 // TiN)
    assert Nseg == ntx * nty
    if use_fft is None:
        use_fft = (L0 * L1) > 33 * 33

    img = np.where(np.isfinite(image), image, nan_fill_value)
    kers = np.asarray(ker_stack, dtype=np.float64)
    if normalize_kernel:
        kers = kers / kers.sum(axis=(1, 2), keepdims=True)

    # pad to tile multiple + conv halo
    P0, P1 = ntx * TiN, nty * TiN
    imgp = np.zeros((P0 + 2 * w0, P1 + 2 * w1))
    imgp[w0 : w0 + N0, w1 : w1 + N1] = img

    dt = jnp.float64
    imgj = jnp.asarray(imgp, dt)

    # extract halo tiles: (Nseg, TiN + 2w0, TiN + 2w1)
    def tile(idx):
        tx = idx // nty
        ty = idx % nty
        return lax.dynamic_slice(
            imgj, (tx * TiN, ty * TiN), (TiN + 2 * w0, TiN + 2 * w1)
        )

    tiles = jax.vmap(tile)(jnp.arange(Nseg))

    if use_fft:
        # batched circular FFT conv on zero-padded tiles: the halo already
        # contains the real data the kernel can reach, and the outer zero pad
        # prevents wrap-around, so the VALID center equals the direct conv
        E0, E1 = TiN + 2 * w0, TiN + 2 * w1
        F0 = int(2 ** np.ceil(np.log2(E0 + L0 - 1)))
        F1 = int(2 ** np.ceil(np.log2(E1 + L1 - 1)))
        kimg = np.zeros((Nseg, F0, F1))
        kimg[:, :L0, :L1] = kers
        kimg = np.roll(np.roll(kimg, -w0, axis=1), -w1, axis=2)  # CSZ
        tilesp = jnp.zeros((Nseg, F0, F1), dt).at[:, :E0, :E1].set(tiles)
        spec = jnp.fft.rfft2(tilesp) * jnp.fft.rfft2(jnp.asarray(kimg, dt))
        conv = jnp.fft.irfft2(spec, s=(F0, F1))
        tiles_out = conv[:, w0 : w0 + TiN, w1 : w1 + TiN]
    else:
        kerj = jnp.asarray(kers[:, ::-1, ::-1], dt)  # conv = corr with flip
        out = lax.conv_general_dilated(
            tiles[:, None],          # (Nseg, 1, H, W)
            kerj[:, None],           # (Nseg, 1, L0, L1)
            (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=1,
            batch_group_count=Nseg,
            precision=lax.Precision.HIGHEST,
        )
        # out: (1, Nseg, TiN, TiN) — one kernel per tile via batch groups
        tiles_out = out[0]

    stitched = tiles_out.reshape(ntx, nty, TiN, TiN).transpose(0, 2, 1, 3).reshape(P0, P1)
    return np.array(stitched[:N0, :N1], dtype=np.float64)


def grid_convolve_labels(
    image: np.ndarray,
    AllocatedL: np.ndarray,
    ker_stack: np.ndarray,
    nan_fill_value: float = 0.0,
    normalize_kernel: bool = True,
    use_fft: bool = False,
) -> np.ndarray:
    """Arbitrary label map fallback (reference GSVC semantics: per-segment
    extended cutout with zero-fill boundary, stitch the interior back)."""
    from sfft_jax.utils.convolve import convolve2d

    img = np.where(np.isfinite(image), image, nan_fill_value)
    N0, N1 = img.shape
    Nseg, L0, L1 = ker_stack.shape
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    IBx, IBy = w0 + 1, w1 + 1
    out = np.zeros((N0, N1))
    for idx in range(Nseg):
        ker = ker_stack[idx]
        lX, lY = np.where(AllocatedL == idx)
        xs, xe = lX.min(), lX.max()
        ys, ye = lY.min(), lY.max()
        xEs, xEe = max(0, xs - IBx), min(N0 - 1, xe + IBx)
        yEs, yEe = max(0, ys - IBy), min(N1 - 1, ye + IBy)
        cut = img[xEs : xEe + 1, yEs : yEe + 1]
        conv = convolve2d(cut, ker, boundary="fill", fill_value=0.0,
                          normalize_kernel=normalize_kernel, nan_treatment="fill")
        out[xs : xe + 1, ys : ye + 1] = conv[xs - xEs : xs - xEs + (xe + 1 - xs),
                                             ys - yEs : ys - yEs + (ye + 1 - ys)]
    return out


class BSplineGridConvolve:
    """Reference-compatible facade (GSVC_CPU / GSVC_GPU unified)."""

    def __init__(self, PixA_obj, AllocatedL, KerStack, nan_fill_value=0.0,
                 use_fft=False, normalize_kernel=True):
        self.PixA_obj = PixA_obj
        self.AllocatedL = AllocatedL
        self.KerStack = KerStack
        self.nan_fill_value = nan_fill_value
        self.use_fft = use_fft
        self.normalize_kernel = normalize_kernel

    def GSVC(self, TiHW: Optional[int] = None):
        if TiHW is not None:
            return grid_convolve_uniform(
                self.PixA_obj, self.KerStack, TiHW,
                self.nan_fill_value, self.normalize_kernel,
            )
        return grid_convolve_labels(
            self.PixA_obj, self.AllocatedL, self.KerStack,
            self.nan_fill_value, self.normalize_kernel, self.use_fft,
        )
