"""Golden test: reproduce the reference's bundled decorrelation outputs.

Replays test/difference_noise_decorrelation/decorr.py end-to-end with our
framework (FITS I/O, extend-boundary convolution, median stacking, MMM sky
sigma, DCC decorrelation kernel) and compares against the reference's stored
4check FITS products.
"""

import os

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.io import fits
from sfft_jax.post.decorrelation import DeCorrelationCalculator
from sfft_jax.utils.convolve import convolve2d
from sfft_jax.utils.sky import SkyLevelEstimator

CDIR = "/root/reference/test/difference_noise_decorrelation"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(CDIR), reason="reference decorr data absent"
)


def _load(name):
    return fits.getdata(f"{CDIR}/input_data/{name}").T.astype(np.float64)


def _load_check(name):
    return fits.getdata(f"{CDIR}/4check/{name}").T.astype(np.float64)


@pytest.fixture(scope="module")
def pipeline():
    groups = {}
    for grp, tags in [("04", "abcde"), ("18", "abcde")]:
        imgs, mks = [], []
        for t in tags:
            imgs.append(_load(f"DEC-OBS{grp}{t}.mini.fits"))
            mk_path = f"{CDIR}/input_data/DEC-OBS{grp}{t}.MatchKernel.fits"
            mks.append(fits.getdata(mk_path).T.astype(np.float64)
                       if os.path.exists(mk_path) else None)
        groups[grp] = (imgs, mks)

    stacks = {}
    for grp, (imgs, mks) in groups.items():
        conv = [img if mk is None else
                convolve2d(img, mk, boundary="extend", normalize_kernel=False)
                for img, mk in zip(imgs, mks)]
        stacks[grp] = np.median(np.array(conv), axis=0)

    mk_fin = _load("FinalMatchKernel.fits")
    findiff = stacks["04"] - convolve2d(stacks["18"], mk_fin,
                                        boundary="extend", normalize_kernel=False)
    return groups, stacks, mk_fin, findiff


def test_stacks_match_4check(pipeline):
    groups, stacks, _, _ = pipeline
    for grp in ("04", "18"):
        ref = _load_check(f"Stack-DEC-OBS{grp}.fits")
        scale = np.nanstd(ref)
        err = np.sqrt(np.nanmean((stacks[grp] - ref) ** 2))
        assert err < 1e-4 * scale, f"stack {grp} RMS err {err:.3g} vs scale {scale:.3g}"


def test_final_difference_matches_4check(pipeline):
    _, _, _, findiff = pipeline
    ref = _load_check("FinalDifference.fits")
    scale = np.nanstd(ref)
    err = np.sqrt(np.nanmean((findiff - ref) ** 2))
    assert err < 1e-4 * scale


def test_decorr_kernel_and_difference_match_4check(pipeline):
    groups, stacks, mk_fin, findiff = pipeline
    sky = {}
    for grp in ("04", "18"):
        imgs, _ = groups[grp]
        sky[grp] = [SkyLevelEstimator.SLE(img)[1] for img in imgs]

    kdeco = DeCorrelationCalculator.DCC(
        MK_JLst=groups["04"][1], SkySig_JLst=sky["04"],
        MK_ILst=groups["18"][1], SkySig_ILst=sky["18"],
        MK_Fin=mk_fin, KERatio=2.0, VERBOSE_LEVEL=0,
    )
    ref_k = _load_check("DeCorrKernel.fits")
    assert kdeco.shape == ref_k.shape
    err_k = np.abs(kdeco - ref_k).max() / np.abs(ref_k).max()
    assert err_k < 1e-3, f"decorr kernel max rel err {err_k:.3g}"

    dc = convolve2d(findiff, kdeco, boundary="extend", normalize_kernel=False)
    ref_dc = _load_check("FinalDifference.DeCorr.fits")
    scale = np.nanstd(ref_dc)
    err = np.sqrt(np.nanmean((dc - ref_dc) ** 2))
    assert err < 1e-3 * scale, f"decorrelated diff RMS err {err:.3g} vs {scale:.3g}"
