"""Stamp extraction with NaN fill outside the frame.

Reference: Stamp_Generator.SG (sfft/utils/StampGenerator.py) — Cutout2D-based
stamps at IMAGE coordinates (FortranCoor, 1-based pixel centers) with
FILL_VALUE padding where the stamp exceeds the image.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sfft_jax.io import fits


class StampGenerator:
    @staticmethod
    def SG(
        FITS_obj: Optional[str] = None,
        PixA_obj: Optional[np.ndarray] = None,
        EXTINDEX: int = 0,
        COORD: np.ndarray = None,
        COORD_TYPE: str = "IMAGE",
        STAMP_IMGSIZE: Sequence[int] = (64, 64),
        FILL_VALUE: float = np.nan,
        FITS_StpLst: Optional[Sequence[str]] = None,
        VERBOSE_LEVEL: int = 1,
    ) -> List[np.ndarray]:
        assert COORD_TYPE == "IMAGE", "WCS stamps require sfft_jax.utils.wcs"
        if PixA_obj is None:
            PixA_obj = fits.read(FITS_obj, ext=EXTINDEX)[0].T.astype(np.float64)
        N0, N1 = PixA_obj.shape
        sx, sy = int(STAMP_IMGSIZE[0]), int(STAMP_IMGSIZE[1])

        stamps = []
        for x_img, y_img in np.atleast_2d(COORD):
            # FortranCoor center (1-based pixel center) -> 0-based array index
            cx = int(np.round(x_img - 0.5)) - 0  # floor of x-0.5 ~ pixel row
            cy = int(np.round(y_img - 0.5))
            x0 = cx - sx // 2
            y0 = cy - sy // 2
            stamp = np.full((sx, sy), FILL_VALUE, dtype=np.float64)
            xs0, xs1 = max(0, x0), min(N0, x0 + sx)
            ys0, ys1 = max(0, y0), min(N1, y0 + sy)
            if xs1 > xs0 and ys1 > ys0:
                stamp[xs0 - x0 : xs1 - x0, ys0 - y0 : ys1 - y0] = (
                    PixA_obj[xs0:xs1, ys0:ys1]
                )
            stamps.append(stamp)

        if FITS_StpLst is not None:
            for path, stamp in zip(FITS_StpLst, stamps):
                fits.write(path, stamp.T)
        return stamps
