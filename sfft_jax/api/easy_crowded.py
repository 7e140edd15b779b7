"""Easy crowded packet: automatic crowded-field subtraction.

Reference: Easy_CrowdedPacket.ECP (sfft/EasyCrowdedPacket.py:14-397): same
skeleton as the sparse packet with Auto_CrowdedPrep preprocessing (saturation
masking + super-background fill), BGPolyOrder=2 default (images NOT
sky-subtracted), no Hough classification and no Post-Anomaly Check.
"""

from __future__ import annotations

import os.path as pa
import time
from typing import Optional, Tuple

import numpy as np

from sfft_jax.config import make_config
from sfft_jax.core.engine import GeneralSFFT
from sfft_jax.io import fits
from sfft_jax.post.solution import RealizeFluxScaling
from sfft_jax.prep.crowded_prep import AutoCrowdedPrep


class EasyCrowdedPacket:
    @staticmethod
    def ECP_Prep(
        FITS_REF: str, FITS_SCI: str, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "SATURATE", BACK_TYPE: str = "AUTO",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 5.0,
        ANALYSIS_THRESH: float = 5.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=None, BoundarySIZE: int = 0,
        BACK_SIZE_SUPER: int = 128, StarExt_iter: int = 2,
        PriorBanMask=None, VERBOSE_LEVEL: int = 1,
        cfg_overrides: Optional[dict] = None, **_ignored,
    ) -> dict:
        """CPU preprocessing stage (Auto_CrowdedPrep + decisions + input
        assembly); see EasySparsePacket.ESP_Prep for the overlap rationale.
        Reference slice: MultiEasyCrowdedPacket preproc threads."""
        _ACP = AutoCrowdedPrep(
            FITS_REF=FITS_REF, FITS_SCI=FITS_SCI, GAIN_KEY=GAIN_KEY,
            SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE, BACK_VALUE=BACK_VALUE,
            BACK_SIZE=BACK_SIZE, BACK_FILTERSIZE=BACK_FILTERSIZE,
            DETECT_THRESH=DETECT_THRESH, ANALYSIS_THRESH=ANALYSIS_THRESH,
            DETECT_MINAREA=DETECT_MINAREA, DETECT_MAXAREA=DETECT_MAXAREA,
            DEBLEND_MINCONT=DEBLEND_MINCONT, BACKPHOTO_TYPE=BACKPHOTO_TYPE,
            ONLY_FLAGS=ONLY_FLAGS, BoundarySIZE=BoundarySIZE,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
        )
        if VERBOSE_LEVEL in (0, 1, 2):
            print("MeLOn CheckPoint: TRIGGER Crowded-Flavor Auto Preprocessing!")
        SFFTPrepDict = _ACP.AutoMask(
            BACK_SIZE_SUPER=BACK_SIZE_SUPER, StarExt_iter=StarExt_iter,
            PriorBanMask=PriorBanMask,
        )

        FWHM_REF = SFFTPrepDict["FWHM_REF"]
        FWHM_SCI = SFFTPrepDict["FWHM_SCI"]
        assert ForceConv in ("AUTO", "REF", "SCI")
        if ForceConv == "AUTO":
            ConvdSide = "REF" if FWHM_SCI >= FWHM_REF else "SCI"
        else:
            ConvdSide = ForceConv
        if GKerHW is None:
            KerHW = int(np.clip(KerHWRatio * max(FWHM_REF, FWHM_SCI),
                                KerHWLimit[0], KerHWLimit[1]))
        else:
            KerHW = GKerHW

        PixA_REF = SFFTPrepDict["PixA_REF"]
        PixA_SCI = SFFTPrepDict["PixA_SCI"]
        cfg = make_config(
            NX=PixA_REF.shape[0], NY=PixA_REF.shape[1], KerHW=KerHW,
            KerPolyOrder=KerPolyOrder, BGPolyOrder=BGPolyOrder,
            ConstPhotRatio=ConstPhotRatio, **(cfg_overrides or {}),
        )

        SatMask_REF = SFFTPrepDict["REF-SAT-Mask"]
        SatMask_SCI = SFFTPrepDict["SCI-SAT-Mask"]
        NaNmask_U = SFFTPrepDict["Union-NaN-Mask"]
        PixA_mREF = SFFTPrepDict["PixA_mREF"]
        PixA_mSCI = SFFTPrepDict["PixA_mSCI"]

        if ConvdSide == "REF":
            PixA_mI, PixA_mJ = PixA_mREF, PixA_mSCI
            base_I, base_J = PixA_REF, PixA_SCI
            ContamMask_I = SatMask_REF if MaskSatContam else None
            ContamMask_J = SatMask_SCI
        else:
            PixA_mI, PixA_mJ = PixA_mSCI, PixA_mREF
            base_I, base_J = PixA_SCI, PixA_REF
            ContamMask_I = SatMask_SCI if MaskSatContam else None
            ContamMask_J = SatMask_REF
        if NaNmask_U is not None:
            PixA_I = np.where(NaNmask_U, PixA_mI, base_I)
            PixA_J = np.where(NaNmask_U, PixA_mJ, base_J)
        else:
            PixA_I, PixA_J = base_I, base_J

        return {
            "SFFTPrepDict": SFFTPrepDict, "cfg": cfg, "ConvdSide": ConvdSide,
            "KerHW": KerHW, "FWHM_REF": FWHM_REF, "FWHM_SCI": FWHM_SCI,
            "PixA_I": PixA_I, "PixA_J": PixA_J,
            "PixA_mI": PixA_mI, "PixA_mJ": PixA_mJ,
            "ContamMask_I": ContamMask_I, "ContamMask_J": ContamMask_J,
            "NaNmask_U": NaNmask_U,
        }

    @staticmethod
    def ECP_Subtract(
        prep: dict, FITS_REF: str, FITS_SCI: str,
        FITS_DIFF: Optional[str] = None, FITS_Solution: Optional[str] = None,
        KerPolyOrder: int = 2, BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True, MaskSatContam: bool = False,
        VERBOSE_LEVEL: int = 1, precomputed=None, **_ignored,
    ):
        """Device stage: solve+subtract + post-processing + FITS output.
        `precomputed=(Solution, PixA_DIFF)` skips the solve (mesh-batched
        survey dispatch)."""
        SFFTPrepDict = prep["SFFTPrepDict"]
        cfg = prep["cfg"]
        ConvdSide = prep["ConvdSide"]
        KerHW = prep["KerHW"]
        FWHM_REF = prep["FWHM_REF"]
        FWHM_SCI = prep["FWHM_SCI"]
        PixA_I, PixA_J = prep["PixA_I"], prep["PixA_J"]
        PixA_mI, PixA_mJ = prep["PixA_mI"], prep["PixA_mJ"]
        ContamMask_I = prep["ContamMask_I"]
        ContamMask_J = prep["ContamMask_J"]
        NaNmask_U = prep["NaNmask_U"]

        t0 = time.time()
        if precomputed is None:
            Solution, diff, ContamMask_CI = GeneralSFFT.GSS(
                PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg, ContamMask_I=ContamMask_I
            )
        else:
            Solution, diff = precomputed
            ContamMask_CI = None
        Solution = np.asarray(Solution)
        PixA_DIFF = np.asarray(diff)
        if VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn Report: SFFT-SUBTRACTION TAKES [{time.time()-t0:.3f} s]!")

        if ConvdSide == "SCI":
            PixA_DIFF = -PixA_DIFF

        N0, N1 = cfg.N0, cfg.N1
        XY_q = np.array([[N0 / 2.0, N1 / 2.0]]) + 0.5
        fs = RealizeFluxScaling(XY_q).from_solution(Solution, cfg)
        SFFT_FSCAL_MEAN = float(fs[0])

        if NaNmask_U is not None:
            PixA_DIFF = np.where(NaNmask_U, np.nan, PixA_DIFF)
        if MaskSatContam and ContamMask_CI is not None:
            ContamMask_DIFF = np.logical_or(np.asarray(ContamMask_CI), ContamMask_J)
            PixA_DIFF = np.where(ContamMask_DIFF, np.nan, PixA_DIFF)

        if FITS_DIFF is not None:
            _, sci_hdr = fits.read(FITS_SCI)
            hdr = fits.Header()
            for key, value, comment in sci_hdr.cards:
                hdr.add(key, value, comment)
            hdr.add("NAME_REF", pa.basename(FITS_REF), "MeLOn: SFFT")
            hdr.add("NAME_SCI", pa.basename(FITS_SCI), "MeLOn: SFFT")
            hdr.add("FWHM_REF", FWHM_REF, "MeLOn: SFFT")
            hdr.add("FWHM_SCI", FWHM_SCI, "MeLOn: SFFT")
            hdr.add("KERORDER", KerPolyOrder, "MeLOn: SFFT")
            hdr.add("BGORDER", BGPolyOrder, "MeLOn: SFFT")
            hdr.add("CPHOTR", str(ConstPhotRatio), "MeLOn: SFFT")
            hdr.add("KERHW", KerHW, "MeLOn: SFFT")
            hdr.add("CONVD", ConvdSide, "MeLOn: SFFT")
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)

        if FITS_Solution is not None:
            from sfft_jax.api.customized import write_solution_fits

            write_solution_fits(FITS_Solution, Solution, cfg)

        return PixA_DIFF, SFFTPrepDict, Solution, SFFT_FSCAL_MEAN

    @staticmethod
    def ECP(
        FITS_REF: str, FITS_SCI: str, FITS_DIFF: Optional[str] = None,
        FITS_Solution: Optional[str] = None, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "SATURATE", BACK_TYPE: str = "AUTO",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 5.0,
        ANALYSIS_THRESH: float = 5.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=None, BoundarySIZE: int = 0,
        BACK_SIZE_SUPER: int = 128, StarExt_iter: int = 2,
        PriorBanMask=None, VERBOSE_LEVEL: int = 1,
        cfg_overrides: Optional[dict] = None,
    ):
        kw = dict(locals())
        prep = EasyCrowdedPacket.ECP_Prep(**kw)
        return EasyCrowdedPacket.ECP_Subtract(prep, **kw)
