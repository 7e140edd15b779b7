"""Automatic image masking for crowded fields.

Reference: Auto_CrowdedPrep (sfft/AutoCrowdedPrep.py): super-background
(BACK_SIZE_SUPER mesh), very-cold source extraction to find saturated
sources, island refinement + dilation of saturation masks, and masked images
where prohibited zones are replaced by the super-background (images are NOT
sky-subtracted in the crowded flavor).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import ndimage

from sfft_jax.io import fits
from sfft_jax.prep.background import Background
from sfft_jax.prep.sex import PYSEx
from sfft_jax.utils.quantile import TopFlattenWeightedQuantile


class AutoCrowdedPrep:
    def __init__(self, FITS_REF=None, FITS_SCI=None, PixA_REF=None, PixA_SCI=None,
                 REF_header=None, SCI_header=None,
                 GAIN_KEY="GAIN", SATUR_KEY="SATURATE", BACK_TYPE="AUTO",
                 BACK_VALUE=0.0, BACK_SIZE=64, BACK_FILTERSIZE=3,
                 DETECT_THRESH=5.0, ANALYSIS_THRESH=5.0, DETECT_MINAREA=5,
                 DETECT_MAXAREA=0, DEBLEND_MINCONT=0.005,
                 BACKPHOTO_TYPE="LOCAL", ONLY_FLAGS=None, BoundarySIZE=0.0,
                 VERBOSE_LEVEL=1):
        if PixA_REF is None:
            PixA_REF, REF_header = fits.read(FITS_REF)
            PixA_REF = PixA_REF.T.astype(np.float64)
        if PixA_SCI is None:
            PixA_SCI, SCI_header = fits.read(FITS_SCI)
            PixA_SCI = PixA_SCI.T.astype(np.float64)
        self.PixA_REF = PixA_REF
        self.PixA_SCI = PixA_SCI
        self.REF_header = REF_header or fits.Header()
        self.SCI_header = SCI_header or fits.Header()
        self.SATUR_KEY = SATUR_KEY
        self.sex_kwargs = dict(
            GAIN_KEY=GAIN_KEY, SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE,
            BACK_VALUE=BACK_VALUE, BACK_SIZE=BACK_SIZE,
            BACK_FILTERSIZE=BACK_FILTERSIZE, DETECT_THRESH=DETECT_THRESH,
            ANALYSIS_THRESH=ANALYSIS_THRESH, DETECT_MINAREA=DETECT_MINAREA,
            DETECT_MAXAREA=DETECT_MAXAREA, DEBLEND_MINCONT=DEBLEND_MINCONT,
            BACKPHOTO_TYPE=BACKPHOTO_TYPE, ONLY_FLAGS=ONLY_FLAGS,
            XBoundary=BoundarySIZE, YBoundary=BoundarySIZE,
        )
        self.VERBOSE_LEVEL = VERBOSE_LEVEL

    def AutoMask(self, BACK_SIZE_SUPER=128, StarExt_iter=2,
                 PriorBanMask=None) -> Dict:
        PixA_REF, PixA_SCI = self.PixA_REF, self.PixA_SCI

        PixA_SBG_REF = Background(PixA_REF, bw=BACK_SIZE_SUPER,
                                  bh=BACK_SIZE_SUPER, fw=3, fh=3).back()
        PixA_SBG_SCI = Background(PixA_SCI, bw=BACK_SIZE_SUPER,
                                  bh=BACK_SIZE_SUPER, fw=3, fh=3).back()

        def gen_sat_mask(pix, hdr):
            cat, checks, _, _ = PYSEx.PS(
                PixA_obj=pix,
                SExParam=["X_IMAGE", "Y_IMAGE", "FLUX_AUTO", "FLUXERR_AUTO",
                          "FLUX_MAX", "FWHM_IMAGE"],
                CHECKIMAGE_TYPE="SEGMENTATION",
                VERBOSE_LEVEL=self.VERBOSE_LEVEL, **self.sex_kwargs,
            )
            seg = checks[0].astype(int)

            vals = np.array(cat["FWHM_IMAGE"])
            wts = np.array(cat["FLUX_AUTO"]) / np.clip(vals, 1.0, None) ** 2
            fwhm = TopFlattenWeightedQuantile.TFWQ(
                values=vals, weights=wts, quantiles=[0.5], NUM_TOP_END=30)[0]

            satlevel = float(hdr.get(self.SATUR_KEY, np.inf) or np.inf)
            satsel = np.array(cat["FLUX_MAX"]) >= satlevel
            cat_sat = cat[satsel]
            sat_labels = np.array(cat_sat["SEGLABEL"], int)
            SatMask = np.isin(seg, sat_labels) & (seg > 0)

            # island refinement: keep only connected islands containing the
            # saturated source centers (SExtractor outskirt islands dropped)
            XY_SAT = np.array([cat_sat["X_IMAGE"], cat_sat["Y_IMAGE"]]).T
            if len(XY_SAT):
                Lmap = ndimage.label(SatMask)[0]
                satl = Lmap[((XY_SAT[:, 0] - 0.5).astype(int),
                             (XY_SAT[:, 1] - 0.5).astype(int))]
                satl = list(set(satl).difference({0}))
                SatMask = np.isin(Lmap, satl)

            struct0 = ndimage.generate_binary_structure(2, 1)
            struct = ndimage.iterate_structure(struct0, StarExt_iter)
            SatMask = ndimage.grey_dilation(SatMask, footprint=struct)
            return satlevel, fwhm, SatMask.astype(bool), len(cat_sat)

        SATLEVEL_REF, FWHM_REF, SatMask_REF, n_r = gen_sat_mask(PixA_REF, self.REF_header)
        SATLEVEL_SCI, FWHM_SCI, SatMask_SCI, n_s = gen_sat_mask(PixA_SCI, self.SCI_header)
        if self.VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: Estimated [FWHM_REF = {FWHM_REF:.3f} pix]"
                  f" & [FWHM_SCI = {FWHM_SCI:.3f} pix]!")

        NaNmask_U = None
        if PriorBanMask is None:
            ProZone = np.logical_or(SatMask_REF, SatMask_SCI)
        else:
            ProZone = np.logical_or.reduce(
                (PriorBanMask, SatMask_REF, SatMask_SCI))
        NaNmask_REF = np.isnan(PixA_REF)
        NaNmask_SCI = np.isnan(PixA_SCI)
        if NaNmask_REF.any() or NaNmask_SCI.any():
            NaNmask_U = np.logical_or(NaNmask_REF, NaNmask_SCI)
            ProZone[NaNmask_U] = True

        PixA_mREF = np.where(ProZone, PixA_SBG_REF, PixA_REF)
        PixA_mSCI = np.where(ProZone, PixA_SBG_SCI, PixA_SCI)
        ActiveMask = ~ProZone
        if self.VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: Active-Mask Pixel Proportion "
                  f"[{ActiveMask.mean():.2%}]")

        return {
            "PixA_REF": PixA_REF, "PixA_SCI": PixA_SCI,
            "Union-NaN-Mask": NaNmask_U,
            "SATLEVEL_REF": SATLEVEL_REF, "SATLEVEL_SCI": SATLEVEL_SCI,
            "FWHM_REF": FWHM_REF, "FWHM_SCI": FWHM_SCI,
            "REF-SAT-Mask": SatMask_REF, "SCI-SAT-Mask": SatMask_SCI,
            "Active-Mask": ActiveMask,
            "PixA_mREF": PixA_mREF, "PixA_mSCI": PixA_mSCI,
        }
