"""Generate-once golden fixtures for the sparse/crowded auto pipelines.

The reference's sparse/crowded test FITS (DECam 2k x 4k, ZTF M31) are
stripped from this mount (.MISSING_LARGE_BLOBS), so the auto pipelines had
only synthetic unfrozen e2e tests. This tool generates
small DECam-like pairs ONCE, runs the full EasySparse / EasyCrowded packets
on CPU, and freezes the pair FITS + the measured pipeline outputs (diff RMS,
flux-scaling grid stats, post-anomaly counts, prep statistics) into
tests/data/. tests/test_golden_sparse.py / test_golden_crowded.py then
re-run the pipelines against the frozen numbers — a behavior drift anywhere
in extract -> hough -> match -> mask -> solve -> QA fails a golden test,
not just a loose unit bound.

Regenerate deliberately (and commit the diff) with:
    python tools/make_golden_fixtures.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from sfft_jax.io import fits  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")


def sparse_pair():
    """DECam-like sparse field: ~160 stars + galaxies, seeing change
    2.9 -> 3.7 px FWHM, flux ratio 1.18, background offset, mild noise."""
    from tests.test_prep import synth_field

    rng = np.random.default_rng(20260819)
    N0, N1 = 360, 340
    ref, truth = synth_field(rng, N0=N0, N1=N1, nstars=160, fwhm=2.9,
                             bg=0.0, ngal=6, noise=2.0)
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    sci = np.zeros((N0, N1))
    sig = 3.7 / 2.355
    for x0, y0, f in truth:
        amp = 1.18 * f / (2 * np.pi * sig**2)
        sci += amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    sci += 3.0 + rng.normal(0, 2.0, sci.shape)
    # one transient in the science image (should light up the difference
    # and the post-anomaly check)
    tx, ty = 251.0, 77.0
    sci += 4.0e4 / (2 * np.pi * sig**2) * np.exp(
        -((xx - tx) ** 2 + (yy - ty) ** 2) / (2 * sig**2))
    return ref, sci


def crowded_pair():
    from tests.test_prep import synth_field

    rng = np.random.default_rng(20260820)
    ref, _ = synth_field(rng, N0=320, N1=320, nstars=520, fwhm=3.0,
                         bg=600.0, noise=2.5, satur=28000.0)
    sci = 1.12 * (ref - 600.0) + 640.0 + rng.normal(0, 2.5, ref.shape)
    sci = np.minimum(sci, 28000.0)
    return ref, sci


def run_sparse(tdir):
    from sfft_jax.api.easy_sparse import EasySparsePacket

    diff, prepdict, sol, fscal, fsig = EasySparsePacket.ESP(
        os.path.join(tdir, "golden_sparse_ref.fits"),
        os.path.join(tdir, "golden_sparse_sci.fits"),
        ForceConv="AUTO", KerHWLimit=(2, 6), VERBOSE_LEVEL=0,
        PostAnomalyCheck=True,
    )
    act = prepdict["Active-Mask"]
    ss = prepdict["SExCatalog-SubSource"]
    return {
        "fwhm_ref": round(float(prepdict["FWHM_REF"]), 4),
        "fwhm_sci": round(float(prepdict["FWHM_SCI"]), 4),
        "n_subsource": int(len(ss)),
        "n_active_pix": int(np.sum(act)),
        "flux_scal_mean": round(float(fscal), 6),
        "flux_scal_sig": round(float(fsig), 6),
        "n_post_anomaly": int(np.sum(np.asarray(ss["MASK_PostAnomaly"]))),
        "diff_rms_active": round(float(np.sqrt(np.nanmean(diff[act] ** 2))), 6),
        "diff_rms_all": round(float(np.sqrt(np.nanmean(diff ** 2))), 6),
        "sol_l1": round(float(np.sum(np.abs(sol))), 4),
    }


def run_crowded(tdir):
    from sfft_jax.api.easy_crowded import EasyCrowdedPacket

    diff, prepdict, sol, fscal = EasyCrowdedPacket.ECP(
        os.path.join(tdir, "golden_crowded_ref.fits"),
        os.path.join(tdir, "golden_crowded_sci.fits"),
        ForceConv="REF", GKerHW=3, VERBOSE_LEVEL=0,
    )
    act = prepdict["Active-Mask"]
    return {
        "kerhw": 3,
        "n_active_pix": int(np.sum(act)),
        "flux_scal": round(float(fscal), 6),
        "diff_rms_active": round(float(np.sqrt(np.nanmean(diff[act] ** 2))), 6),
        "sol_l1": round(float(np.sum(np.abs(sol))), 4),
    }


def main():
    os.makedirs(DATA, exist_ok=True)
    ref, sci = sparse_pair()
    hdr = fits.Header()
    hdr.add("GAIN", 1.0)
    hdr.add("ESATUR", 1.0e9)
    fits.write(os.path.join(DATA, "golden_sparse_ref.fits"),
               ref.T.astype(np.float32), hdr)
    fits.write(os.path.join(DATA, "golden_sparse_sci.fits"),
               sci.T.astype(np.float32), hdr)

    refc, scic = crowded_pair()
    hdr2 = fits.Header()
    hdr2.add("GAIN", 1.0)
    hdr2.add("SATURATE", 28000.0)
    fits.write(os.path.join(DATA, "golden_crowded_ref.fits"),
               refc.T.astype(np.float32), hdr2)
    fits.write(os.path.join(DATA, "golden_crowded_sci.fits"),
               scic.T.astype(np.float32), hdr2)

    expected = {"sparse": run_sparse(DATA), "crowded": run_crowded(DATA)}
    with open(os.path.join(DATA, "golden_auto_expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    print(json.dumps(expected, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
