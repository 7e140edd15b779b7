"""Frozen golden anchor for the EasySparsePacket auto pipeline.

The reference's DECam sparse test FITS are stripped from this mount, so this
anchors on a committed generated-once DECam-like pair
(tests/data/golden_sparse_*.fits, tools/make_golden_fixtures.py) with frozen
expected outputs — a drift anywhere in extract -> hough classify -> symmetric
match -> CVREJ/EVREJ -> image mask -> solve -> flux scaling -> post-anomaly
check fails here, not just a loose unit bound.
Reference pipeline: sfft/EasySparsePacket.py:17-600.
"""

import json
import os

import numpy as np

import sfft_jax  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_golden_sparse_pipeline():
    from sfft_jax.api.easy_sparse import EasySparsePacket

    with open(os.path.join(DATA, "golden_auto_expected.json")) as f:
        exp = json.load(f)["sparse"]

    diff, prepdict, sol, fscal, fsig = EasySparsePacket.ESP(
        os.path.join(DATA, "golden_sparse_ref.fits"),
        os.path.join(DATA, "golden_sparse_sci.fits"),
        ForceConv="AUTO", KerHWLimit=(2, 6), VERBOSE_LEVEL=0,
        PostAnomalyCheck=True,
    )
    act = prepdict["Active-Mask"]
    ss = prepdict["SExCatalog-SubSource"]

    # discrete pipeline decisions: frozen exactly
    assert len(ss) == exp["n_subsource"]
    assert int(np.sum(act)) == exp["n_active_pix"]
    assert int(np.sum(np.asarray(ss["MASK_PostAnomaly"]))) == \
        exp["n_post_anomaly"]

    # measured statistics: small tolerance for jax/numpy version drift
    np.testing.assert_allclose(prepdict["FWHM_REF"], exp["fwhm_ref"],
                               rtol=1e-3)
    np.testing.assert_allclose(prepdict["FWHM_SCI"], exp["fwhm_sci"],
                               rtol=1e-3)
    np.testing.assert_allclose(fscal, exp["flux_scal_mean"], rtol=1e-4)
    np.testing.assert_allclose(fsig, exp["flux_scal_sig"], atol=1e-6)
    np.testing.assert_allclose(
        float(np.sqrt(np.nanmean(diff[act] ** 2))),
        exp["diff_rms_active"], rtol=1e-4)
    np.testing.assert_allclose(
        float(np.sqrt(np.nanmean(diff ** 2))), exp["diff_rms_all"],
        rtol=1e-4)
    np.testing.assert_allclose(float(np.sum(np.abs(sol))), exp["sol_l1"],
                               rtol=1e-5)

    # physical sanity that must hold regardless of frozen numbers: the
    # planted transient at (251, 77) survives subtraction at high S/N
    assert np.nanmax(np.abs(diff[246:256, 72:82])) > \
        20 * exp["diff_rms_active"]
