"""Always-on mini golden test: the full NIRCam B-spline pipeline on a 400^2
sub-stamp (cross-convolution -> B-spline SFFT with Tikhonov regularization ->
tile decorrelation -> grid convolution -> MC noise propagation -> SNR map),
checked against the paper's quality gates and the reference 4check product.

~50 s on this CPU — runs in the default suite so the flagship pipeline's
parity evidence cannot silently rot (the full-size golden test is
RUN_SLOW-gated). The full 900^2 GKerHW=11 version lives
in tests/test_golden_nircam.py.
"""

import os
import sys

import numpy as np
import pytest

CDIR = "/root/reference/test/subtract_test_nircam"

pytestmark = pytest.mark.skipif(not os.path.isdir(CDIR),
                                reason="reference data absent")


def test_nircam_mini_pipeline(tmp_path):
    sys.path.insert(0, "/root/repo/examples")
    from subtract_nircam import run

    out = run(str(tmp_path), GKerHW=7, mc_nsamp=8, crop=400, n_reg=192)
    # paper's quality gate: background SNR ~ N(0, 1), skewness ~ 0 (the
    # sub-stamp with a truncated kernel is a bit noisier than the full run:
    # measured std 1.16, skew -0.017, corr 0.845)
    assert 0.85 < out["std"] < 1.35, f"background SNR std {out['std']}"
    assert abs(out["skew"]) < 0.3, f"background SNR skew {out['skew']}"
    assert out["corr"] is not None and out["corr"] > 0.78, (
        f"correlation vs 4check {out['corr']}"
    )
