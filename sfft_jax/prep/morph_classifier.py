"""Hough morphological point-source classifier.

Reference: Hough_MorphClassifier (sfft/utils/HoughMorphClassifier.py): detect
the point-source belt in the MAG_AUTO -- FLUX_RADIUS diagram with a Hough
transform (the belt is a nearly horizontal line), label sources FR-S/M/L,
derive GoodSources / PointSources and a flux-weighted-median FWHM; standby
flux-weighted method when no belt is found.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np

from sfft_jax.prep.sex import PYSEx
from sfft_jax.utils.hough import HoughDetection
from sfft_jax.utils.quantile import TopFlattenWeightedQuantile
from sfft_jax.utils.table import Table


class HoughMorphClassifier:
    @staticmethod
    def MakeCatalog(
        FITS_obj=None, PixA_obj=None, GAIN_KEY="GAIN", SATUR_KEY="SATURATE",
        BACK_TYPE="AUTO", BACK_VALUE=0.0, BACK_SIZE=64, BACK_FILTERSIZE=3,
        DETECT_THRESH=1.5, ANALYSIS_THRESH=1.5, DETECT_MINAREA=5,
        DETECT_MAXAREA=0, DEBLEND_MINCONT=0.005, BACKPHOTO_TYPE="LOCAL",
        CHECKIMAGE_TYPE="NONE", AddRD=False, ONLY_FLAGS=[0], BoundarySIZE=30,
        AddSNR=True, VERBOSE_LEVEL=1,
    ):
        SExParam = ["X_IMAGE", "Y_IMAGE", "FLUX_AUTO", "FLUXERR_AUTO",
                    "MAG_AUTO", "MAGERR_AUTO", "FLAGS", "FLUX_RADIUS",
                    "FWHM_IMAGE", "A_IMAGE", "B_IMAGE"]
        if AddSNR:
            SExParam.append("SNR_WIN")
        return PYSEx.PS(
            FITS_obj=FITS_obj, PixA_obj=PixA_obj, SExParam=SExParam,
            GAIN_KEY=GAIN_KEY, SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE,
            BACK_VALUE=BACK_VALUE, BACK_SIZE=BACK_SIZE,
            BACK_FILTERSIZE=BACK_FILTERSIZE, DETECT_THRESH=DETECT_THRESH,
            ANALYSIS_THRESH=ANALYSIS_THRESH, DETECT_MINAREA=DETECT_MINAREA,
            DETECT_MAXAREA=DETECT_MAXAREA, DEBLEND_MINCONT=DEBLEND_MINCONT,
            BACKPHOTO_TYPE=BACKPHOTO_TYPE, CHECKIMAGE_TYPE=CHECKIMAGE_TYPE,
            AddRD=AddRD, ONLY_FLAGS=ONLY_FLAGS, XBoundary=BoundarySIZE,
            YBoundary=BoundarySIZE, MDIR=None, VERBOSE_LEVEL=VERBOSE_LEVEL,
        )

    @staticmethod
    def Classifier(AstSEx: Table, Hough_MINFR=0.1, Hough_MAXFR=10.0,
                   Hough_PeakClip=0.7, BeltHW=0.2, PointSource_MINELLIP=0.3,
                   VERBOSE_LEVEL=1):
        A = np.array(AstSEx["A_IMAGE"])
        B = np.array(AstSEx["B_IMAGE"])
        MA_FR = np.array([AstSEx["MAG_AUTO"], AstSEx["FLUX_RADIUS"]]).T

        ELLIP = (A - B) / (A + B)
        MASK_ELLIP = (ELLIP < PointSource_MINELLIP) if PointSource_MINELLIP \
            is not None else np.ones(len(ELLIP), bool)

        MA, FR = MA_FR[:, 0], MA_FR[:, 1]
        MA_MID = np.nanmedian(MA)
        Hmask = np.logical_and.reduce((
            FR > Hough_MINFR, FR < Hough_MAXFR,
            MA > MA_MID - 7.0, MA < MA_MID + 7.0,
        ))

        _res = HoughDetection.HD(XY_obj=MA_FR, Hmask=Hmask, grid_pixsize=0.05,
                                 count_thresh=1, peak_clip=Hough_PeakClip)
        ThetaPeaks, RhoPeaks, ScaLineDIST = _res[2:]

        BeltTheta_thresh = 0.2
        nhor = np.where(np.abs(ThetaPeaks) < BeltTheta_thresh)[0] \
            if len(ThetaPeaks) else np.array([], int)

        if len(nhor) == 0:
            bingo = None
            warnings.warn("MeLOn WARNING: [NO] near-horizon peak as "
                          "Point-Source-Belt!")
        elif len(nhor) == 1:
            bingo = nhor[0]
        else:
            bingo = int(np.min(nhor))
            warnings.warn("MeLOn WARNING: [MULTIPLE] near-horizon peaks, "
                          "of which [strongest] as Point-Source-Belt!")

        if bingo is not None:
            BeltTheta = ThetaPeaks[bingo]
            BeltRho = RhoPeaks[bingo]
            MASK_FRM = ScaLineDIST[:, bingo] < BeltHW
            MASK_FRL = (MA_FR[:, 0] * np.sin(BeltTheta)
                        + MA_FR[:, 1] * np.cos(BeltTheta) > BeltRho)
            MASK_FRL = np.logical_and(MASK_FRL, ~MASK_FRM)
        else:
            BeltTheta, BeltRho = np.nan, np.nan
            warnings.warn("MeLOn WARNING: [STANDBY] method to determine "
                          "FR-S/M/L regions!")
            _values = MA_FR[:, 1]
            _weights = np.array(AstSEx["FLUX_AUTO"], dtype=np.float64)
            _weights = _weights / np.clip(_values, 0.5, None) ** 2
            FR_MID = TopFlattenWeightedQuantile.TFWQ(
                values=_values, weights=_weights, quantiles=[0.5],
                NUM_TOP_END=30)[0]
            MASK_FRM = np.abs(MA_FR[:, 1] - FR_MID) < BeltHW
            MASK_FRL = MA_FR[:, 1] - FR_MID > BeltHW

        MASK_FRS = ~np.logical_or(MASK_FRM, MASK_FRL)
        LABEL_FR = np.array(["FR-S"] * len(AstSEx))
        LABEL_FR[MASK_FRM] = "FR-M"
        LABEL_FR[MASK_FRL] = "FR-L"

        MASK_GS = ~MASK_FRS
        MASK_PS = np.logical_and(MASK_FRM, MASK_ELLIP)
        if VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: [{MASK_GS.sum()}] Good-Sources | "
                  f"[{MASK_PS.sum()}] Point-Sources on the Image!")

        _values = np.array(AstSEx[MASK_PS]["FWHM_IMAGE"])
        _weights = np.array(AstSEx[MASK_PS]["FLUX_AUTO"])
        FWHM = round(float(TopFlattenWeightedQuantile.TFWQ(
            values=_values, weights=_weights, quantiles=[0.5],
            NUM_TOP_END=30)[0]), 6)
        if VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: Estimated [FWHM = {FWHM:.3f} pix] "
                  "from Point-Sources")
        return BeltTheta, BeltRho, LABEL_FR, MASK_GS, MASK_PS, FWHM
