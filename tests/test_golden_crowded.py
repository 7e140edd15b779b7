"""Frozen golden anchor for the EasyCrowdedPacket auto pipeline.

Crowded twin of tests/test_golden_sparse.py: committed generated-once
saturated crowded pair + frozen expected outputs
(tools/make_golden_fixtures.py). Reference: sfft/EasyCrowdedPacket.py:14-397.
"""

import json
import os

import numpy as np

import sfft_jax  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_golden_crowded_pipeline():
    from sfft_jax.api.easy_crowded import EasyCrowdedPacket

    with open(os.path.join(DATA, "golden_auto_expected.json")) as f:
        exp = json.load(f)["crowded"]

    diff, prepdict, sol, fscal = EasyCrowdedPacket.ECP(
        os.path.join(DATA, "golden_crowded_ref.fits"),
        os.path.join(DATA, "golden_crowded_sci.fits"),
        ForceConv="REF", GKerHW=exp["kerhw"], VERBOSE_LEVEL=0,
    )
    act = prepdict["Active-Mask"]

    assert int(np.sum(act)) == exp["n_active_pix"]
    np.testing.assert_allclose(fscal, exp["flux_scal"], rtol=1e-4)
    np.testing.assert_allclose(
        float(np.sqrt(np.nanmean(diff[act] ** 2))),
        exp["diff_rms_active"], rtol=1e-4)
    np.testing.assert_allclose(float(np.sum(np.abs(sol))), exp["sol_l1"],
                               rtol=1e-5)
