"""JWST/NIRCam B-spline subtraction + noise decorrelation pipeline.

Replicates the reference's test/subtract_test_nircam/subtract4nircam.ipynb with
sfft_jax components end-to-end:

  1. cross-convolution of REF/SCI with each other's WebbPSF models
  2. B-spline SFFT subtraction (deg-2 kernel with 2x2 internal knots,
     SEPARATE deg-2 polynomial scaling, Tikhonov regularization)
  3. tile-grid matching-kernel realization + per-tile decorrelation kernels
  4. grid-wise spatially-varying decorrelation convolution
  5. Monte-Carlo noise propagation -> differential SNR map

Run: python examples/subtract_nircam.py [--kerhw 11] [--out /tmp/nircam_out] [--cpu]
The final SNR map is compared against the reference's stored 4check product
when available.
"""

from __future__ import annotations

import argparse
import os
import os.path as pa
import sys
import time

import numpy as np

sys.path.insert(0, pa.dirname(pa.dirname(pa.abspath(__file__))))

from sfft_jax.io import fits
from sfft_jax.api.bspline import (
    BSplinePacket, BSplineMatchingKernel, make_bspline_config)
from sfft_jax.post.decorrelation import BSplineDeCorrelation
from sfft_jax.post.fftkits import fft_convolve
from sfft_jax.post.grid_convolve import BSplineGridConvolve
from sfft_jax.post.solution import read_solution_fits
from sfft_jax.utils.sky import SkyLevelEstimator
from sfft_jax.utils.multiproc import MultiProc

CDIR = "/root/reference/test/subtract_test_nircam"
REFNAME = "jw01324001001-01324-o001_t001_nircam_clear-f200w_i2d_stamp"
SCINAME = "jw02561001002-02561-o001_t003_nircam_clear-f200w_i2d_stamp"


def normalized_convolve(img, kernel):
    """astropy convolve_fft(boundary='fill', nan_treatment='fill',
    normalize_kernel=True) equivalent."""
    return np.asarray(fft_convolve(img, kernel / kernel.sum(),
                                   pad_fill_value=0.0, nan_fill_value=0.0))


def run(out_dir: str, GKerHW: int = 11, lambda_reg: float = 3e-5,
        mc_nsamp: int = 32, crop: int = 0, n_reg: int = 512):
    """crop > 0 runs the whole pipeline on the [:crop, :crop] sub-stamp (the
    always-on mini golden test uses this; the full 900^2 run is RUN_SLOW)."""
    os.makedirs(out_dir, exist_ok=True)
    t_all = time.time()

    # ---- load inputs ---------------------------------------------------
    lREF = fits.getdata(f"{CDIR}/input_data/{REFNAME}.fits").T.astype(np.float64)
    lSCI = fits.getdata(f"{CDIR}/input_data/{SCINAME}.fits").T.astype(np.float64)
    PSF_REF = fits.getdata(f"{CDIR}/auxiliary/{REFNAME}.WebbPSF.fits").T.astype(np.float64)
    PSF_SCI = fits.getdata(f"{CDIR}/auxiliary/{SCINAME}.WebbPSF.fits").T.astype(np.float64)
    SUBTMASK = fits.getdata(f"{CDIR}/auxiliary/{SCINAME}.mask4sfft.fits").T.astype(bool)
    if crop:
        lREF = lREF[:crop, :crop]
        lSCI = lSCI[:crop, :crop]
        SUBTMASK = SUBTMASK[:crop, :crop]
    N0, N1 = lREF.shape

    # ---- step 1: cross-convolution ------------------------------------
    t0 = time.time()
    lREF_convd = normalized_convolve(np.nan_to_num(lREF), PSF_SCI)
    lSCI_convd = normalized_convolve(np.nan_to_num(lSCI), PSF_REF)
    print(f"[1] cross-convolution: {time.time()-t0:.1f}s")

    for name, arr in [("ref_convd", lREF_convd), ("sci_convd", lSCI_convd)]:
        fits.write(f"{out_dir}/{name}.fits", arr.T)
        fits.write(f"{out_dir}/m{name}.fits",
                   np.where(SUBTMASK, arr, 0.0).T)

    # ---- step 2: B-spline SFFT ----------------------------------------
    t0 = time.time()
    np.random.seed(10086)
    XY_REG = np.array([np.random.uniform(10.0, N0 - 10.0, n_reg),
                       np.random.uniform(10.0, N1 - 10.0, n_reg)]).T
    kw = dict(
        KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[0.5 + N0 / 3, 0.5 + N0 * 2 / 3],
        KerIntKnotY=[0.5 + N1 / 3, 0.5 + N1 * 2 / 3],
        SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
        BkgSpType="Polynomial", BkgSpDegree=0,
        REGULARIZE_KERNEL=True, IGNORE_LAPLACIAN_KERCENT=True,
        XY_REGULARIZE=XY_REG, LAMBDA_REGULARIZE=lambda_reg,
    )
    FITS_Solution = f"{out_dir}/sfftsolution.fits"
    sol, diff = BSplinePacket.BSP(
        f"{out_dir}/ref_convd.fits", f"{out_dir}/sci_convd.fits",
        f"{out_dir}/mref_convd.fits", f"{out_dir}/msci_convd.fits",
        FITS_DIFF=f"{out_dir}/sfftdiff.fits", FITS_Solution=FITS_Solution,
        ForceConv="REF", GKerHW=GKerHW, **kw,
    )
    cfg = make_bspline_config(N0, N1, GKerHW, **kw)
    print(f"[2] B-spline SFFT ({cfg.NEQ} dof): {time.time()-t0:.1f}s")

    # ---- step 3: tile grid + per-tile decorrelation kernels -----------
    t0 = time.time()
    TiHW = round(5 * GKerHW)
    TiN = 2 * TiHW + 1
    XY_TiC = []
    AllocatedL = np.zeros((N0, N1), dtype=int)
    lab = 0
    for xs in np.arange(0, N0, TiN):
        xe = min(xs + TiN, N0)
        for ys in np.arange(0, N1, TiN):
            ye = min(ys + TiN, N1)
            AllocatedL[xs:xe, ys:ye] = lab
            XY_TiC.append([0.5 + xs + (xe - xs) / 2.0,
                           0.5 + ys + (ye - ys) / 2.0])
            lab += 1
    XY_TiC = np.array(XY_TiC)
    NTILE = len(XY_TiC)

    MKerStack = BSplineMatchingKernel(XY_TiC).from_solution(sol, cfg)
    bkgsig_lREF = SkyLevelEstimator.SLE(lREF)[1]
    bkgsig_lSCI = SkyLevelEstimator.SLE(lSCI)[1]

    def func_decorr(idx):
        # BDC = reference notebook's per-tile decorrelation (with the
        # default DENO_CLIP_RATIO=1e5 denominator clipping)
        return BSplineDeCorrelation.BDC(
            MK_JLst=[PSF_REF], SkySig_JLst=[bkgsig_lSCI],
            MK_ILst=[PSF_SCI], SkySig_ILst=[bkgsig_lREF],
            MK_Fin=MKerStack[idx], KERatio=2.0, VERBOSE_LEVEL=0,
        )

    MPD = MultiProc.MP(np.arange(NTILE), func_decorr, nproc=8, mode="threading")
    DCKerStack = np.array([MPD[i] for i in range(NTILE)])
    print(f"[3] {NTILE} tile decorrelation kernels: {time.time()-t0:.1f}s "
          f"(bkgsig REF/SCI = {bkgsig_lREF:.4f}/{bkgsig_lSCI:.4f})")

    # ---- step 4: grid decorrelation convolution -----------------------
    t0 = time.time()
    PixA_DIFF = np.asarray(diff)
    GSVC = BSplineGridConvolve(PixA_DIFF, AllocatedL, DCKerStack,
                               nan_fill_value=0.0, use_fft=True,
                               normalize_kernel=True)
    PixA_DCDIFF = GSVC.GSVC(TiHW=TiHW)
    bmask = np.ones((N0, N1), bool)
    bmask[GKerHW:-GKerHW, GKerHW:-GKerHW] = False
    PixA_DCDIFF[bmask] = 0.0
    fits.write(f"{out_dir}/sfftdiff.DeCorrelated.fits", PixA_DCDIFF.T)
    print(f"[4] grid decorrelation convolution: {time.time()-t0:.1f}s")

    # ---- step 5: MC noise propagation -> SNR map ----------------------
    t0 = time.time()
    noise_lREF = fits.getdata(f"{CDIR}/auxiliary/{REFNAME}.noise.fits").T.astype(np.float64)
    noise_lSCI = fits.getdata(f"{CDIR}/auxiliary/{SCINAME}.noise.fits").T.astype(np.float64)
    if crop:
        noise_lREF = noise_lREF[:crop, :crop]
        noise_lSCI = noise_lSCI[:crop, :crop]
    DCKerMean = DCKerStack.mean(axis=0)
    MKerMean = MKerStack.mean(axis=0)

    def mc_noise(noise_map, kernels, normalizes, seed0):
        def one(idx):
            rs = np.random.RandomState(seed0 + idx)
            samp = rs.normal(0, 1, noise_map.shape) * noise_map
            for ker, norm in zip(kernels, normalizes):
                k = ker / ker.sum() if norm else ker
                samp = normalized_convolve(samp, k) if norm else np.asarray(
                    fft_convolve(samp, k, 0.0, 0.0))
            return samp
        out = MultiProc.MP(np.arange(mc_nsamp), one, nproc=8, mode="threading")
        return np.array([out[i] for i in range(mc_nsamp)])

    sampS = mc_noise(np.nan_to_num(noise_lSCI), [PSF_REF, DCKerMean],
                     [True, True], 10086)
    sampR = mc_noise(np.nan_to_num(noise_lREF), [PSF_SCI, MKerMean, DCKerMean],
                     [True, False, True], 2 * 10086)
    noiseD = np.std(sampS - sampR, axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        SNR = np.where(noiseD > 0, PixA_DCDIFF / noiseD, 0.0)
    SNR[bmask] = 0.0
    fits.write(f"{out_dir}/sfftdiff.DeCorrelated.SNR.fits", SNR.T)
    print(f"[5] MC noise propagation ({mc_nsamp} samples): {time.time()-t0:.1f}s")

    # ---- quality gate: background SNR ~ N(0, 1) -----------------------
    inner = ~bmask
    inner[np.abs(SNR) > 10] = False
    bkg_snr = SNR[inner & (np.abs(SNR) < 5)]
    q1, q3 = np.percentile(bkg_snr, [25, 75])
    std = (q3 - q1) / 1.349
    from scipy.stats import skew
    sk = skew(bkg_snr[np.abs(bkg_snr - np.mean(bkg_snr)) < 3 * std])
    print(f"SNR stats: std={std:.3f} (target ~1), skew={sk:.3f} (target ~0)")

    check = f"{CDIR}/4check/{SCINAME}.crossConvd.sfftdiff.DeCorrelated.SNR.fits"
    corr = None
    if os.path.exists(check):
        ref_snr = fits.getdata(check).T.astype(np.float64)
        if crop:
            ref_snr = ref_snr[:crop, :crop]
        sel = (~bmask) & np.isfinite(ref_snr) & np.isfinite(SNR)
        corr = float(np.corrcoef(SNR[sel].ravel(), ref_snr[sel].ravel())[0, 1])
        rms = float(np.sqrt(np.mean((SNR[sel] - ref_snr[sel]) ** 2)))
        print(f"vs 4check SNR map: correlation={corr:.4f}, RMS dev={rms:.3f}")

    print(f"TOTAL: {time.time()-t_all:.1f}s")
    return dict(std=std, skew=float(sk), corr=corr, SNR=SNR)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--kerhw", type=int, default=11)
    ap.add_argument("--out", default="/tmp/nircam_out")
    ap.add_argument("--mc", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    run(args.out, GKerHW=args.kerhw, mc_nsamp=args.mc)
