"""Sky subtraction: object-masked mesh background removal.

Reference: SEx_SkySubtract.SSS (sfft/utils/SExSkySubtract.py:13-122) — build an
object mask (OBJECTS check image), estimate sky and rms meshes on the masked
image, write the sky-subtracted FITS with SKYDIP/SKYPEAK/ESATUR headers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sfft_jax.io import fits
from sfft_jax.prep.background import Background
from sfft_jax.prep.sex import PYSEx


class SExSkySubtract:
    @staticmethod
    def SSS(FITS_obj=None, PixA_obj=None, obj_header=None,
            FITS_skysub: Optional[str] = None, FITS_sky: Optional[str] = None,
            FITS_skyrms: Optional[str] = None, SATUR_KEY="SATURATE",
            ESATUR_KEY="ESATUR", BACK_SIZE=64, BACK_FILTERSIZE=3,
            DETECT_THRESH=1.5, DETECT_MINAREA=5, DETECT_MAXAREA=0,
            VERBOSE_LEVEL=1, MDIR=None):
        if PixA_obj is None:
            data, obj_header = fits.read(FITS_obj)
            PixA_obj = data.T.astype(np.float64)
        obj_header = obj_header or fits.Header()

        _, checks, _, _ = PYSEx.PS(
            PixA_obj=PixA_obj, SExParam=["X_IMAGE", "Y_IMAGE"],
            GAIN_KEY="PHGAIN", SATUR_KEY=SATUR_KEY, BACK_TYPE="AUTO",
            BACK_SIZE=BACK_SIZE, BACK_FILTERSIZE=BACK_FILTERSIZE,
            DETECT_THRESH=DETECT_THRESH, ANALYSIS_THRESH=1.5,
            DETECT_MINAREA=DETECT_MINAREA, DETECT_MAXAREA=DETECT_MAXAREA,
            DEBLEND_MINCONT=0.005, BACKPHOTO_TYPE="GLOBAL",
            CHECKIMAGE_TYPE="OBJECTS", VERBOSE_LEVEL=VERBOSE_LEVEL,
        )
        detect_mask = checks[0].astype(bool)

        masked = PixA_obj.astype(np.float64, copy=True)
        masked[detect_mask] = np.nan
        bkg = Background(masked, bw=BACK_SIZE, bh=BACK_SIZE,
                         fw=BACK_FILTERSIZE, fh=BACK_FILTERSIZE)
        PixA_sky = bkg.back()
        PixA_skyrms = bkg.rms()
        PixA_skysub = PixA_obj - PixA_sky

        q1, q3 = np.percentile(PixA_sky, [25, 75])
        iqr = q3 - q1
        SKYDIP = q1 - 1.5 * iqr
        SKYPEAK = q3 + 1.5 * iqr

        def _write(path, arr, add_esatur=False):
            hdr = fits.Header()
            for key, value, comment in obj_header.cards:
                hdr.add(key, value, comment)
            hdr.set("SKYDIP", SKYDIP, "MeLOn: IQR-MINIMUM of SEx-SKY-MAP")
            hdr.set("SKYPEAK", SKYPEAK, "MeLOn: IQR-MAXIMUM of SEx-SKY-MAP")
            if add_esatur and SATUR_KEY in hdr:
                hdr.set(ESATUR_KEY, float(hdr[SATUR_KEY]) - SKYPEAK,
                        "MeLOn: Effective SATURATE after SEx-SKY-SUB")
            fits.write(path, arr.T, hdr)

        if FITS_skysub is not None:
            _write(FITS_skysub, PixA_skysub, add_esatur=True)
        if FITS_sky is not None:
            _write(FITS_sky, PixA_sky)
        if FITS_skyrms is not None:
            _write(FITS_skyrms, PixA_skyrms)
        return SKYDIP, SKYPEAK, PixA_skysub, PixA_sky, PixA_skyrms
