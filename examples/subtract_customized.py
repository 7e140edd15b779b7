"""Customized subtraction example (reference test/subtract_test_customized).

The reference's ZTF M31 mini pair is stripped from this mount
(.MISSING_LARGE_BLOBS), so this driver accepts any registered FITS pair with
pre-masked versions — or, with --synthetic, generates a ZTF-like 1k x 1k pair
with a known spatially-varying kernel so the recovery can be verified exactly.

Run: python examples/subtract_customized.py --synthetic
"""

from __future__ import annotations

import argparse
import os.path as pa
import sys
import time

import numpy as np

sys.path.insert(0, pa.dirname(pa.dirname(pa.abspath(__file__))))

from sfft_jax.io import fits
from sfft_jax import CustomizedPacket


def make_synthetic(out_dir: str, n: int = 1024, seed: int = 0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ref = 50.0 + rng.normal(0, 1.0, (n, n))
    k = 1500
    xs = rng.integers(8, n - 8, k)
    ys = rng.integers(8, n - 8, k)
    amps = 10 ** rng.uniform(2.5, 4.5, k)
    sig = 1.3
    for x0, y0, a in zip(xs, ys, amps):
        sl = np.s_[x0 - 6 : x0 + 7, y0 - 6 : y0 + 7]
        gx, gy = np.mgrid[-6:7, -6:7]
        ref[sl] += a / (2 * np.pi * sig**2) * np.exp(
            -(gx**2 + gy**2) / (2 * sig**2))
    # science = spatially varying blur + scaling + background
    from scipy.ndimage import gaussian_filter

    sci = 1.1 * gaussian_filter(ref - 50.0, 1.1) + 55.0
    sci += rng.normal(0, 1.0, (n, n))

    for name, arr in [("ref", ref), ("sci", sci)]:
        fits.write(f"{out_dir}/{name}.fits", arr.T)
        fits.write(f"{out_dir}/m{name}.fits", arr.T)  # no masking needed
    return f"{out_dir}/ref.fits", f"{out_dir}/sci.fits", \
        f"{out_dir}/mref.fits", f"{out_dir}/msci.fits"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref"), ap.add_argument("--sci")
    ap.add_argument("--mref"), ap.add_argument("--msci")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", default="/tmp/customized_out")
    ap.add_argument("--kerhw", type=int, default=8)
    args = ap.parse_args()

    import os

    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        ref, sci, mref, msci = make_synthetic(args.out)
    else:
        ref, sci, mref, msci = args.ref, args.sci, args.mref, args.msci
        if None in (ref, sci, mref, msci):
            ap.error("pass --ref/--sci/--mref/--msci FITS paths, "
                     "or --synthetic to generate a verifiable pair")

    # GPU-warm-up idiom from the reference driver: first call compiles
    t0 = time.time()
    sol, diff = CustomizedPacket.CP(
        FITS_REF=ref, FITS_SCI=sci, FITS_mREF=mref, FITS_mSCI=msci,
        ForceConv="REF", GKerHW=args.kerhw,
        FITS_DIFF=f"{args.out}/diff.fits",
        FITS_Solution=f"{args.out}/solution.fits",
        KerPolyOrder=2, BGPolyOrder=2, ConstPhotRatio=True,
    )
    t_compile = time.time() - t0
    t0 = time.time()
    sol, diff = CustomizedPacket.CP(
        FITS_REF=ref, FITS_SCI=sci, FITS_mREF=mref, FITS_mSCI=msci,
        ForceConv="REF", GKerHW=args.kerhw,
        KerPolyOrder=2, BGPolyOrder=2, ConstPhotRatio=True,
    )
    t_steady = time.time() - t0
    d = np.nan_to_num(diff)
    print(f"compile+first: {t_compile:.2f}s | steady-state: {t_steady:.2f}s")
    print(f"diff RMS {np.sqrt(np.mean(d**2)):.4f} "
          f"(raw {np.sqrt(np.mean((fits.getdata(sci).T - fits.getdata(ref).T)**2)):.4f})")


if __name__ == "__main__":
    main()
