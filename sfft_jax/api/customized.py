"""Customized packet: user-provided masked image pair, FITS or array I/O.

Reference: Customized_Packet.CP (sfft/CustomizedPacket.py:12-223) and the
zero-copy PureCupy_Customized_Packet.PCCP (sfft/PureCupyCustomizedPacket.py:
39-187). The array-level entry point (PureJAXCustomizedPacket) is the natural
JAX shape — device arrays in, device arrays out, fully jitted.

Conventions preserved from the reference:
  * Images are read as fits.getdata(...).T so axis0 = X = NAXIS1.
  * ForceConv='REF': DIFF = SCI - Conv(REF); ForceConv='SCI':
    DIFF = -(Conv(SCI) - REF sign handling) i.e. the returned DIFF is flipped
    so transients on SCI are always positive.
  * NaN union of REF/SCI is patched with the masked images for the solve and
    re-masked to NaN in the output.
"""

from __future__ import annotations

import os.path as pa
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig, make_config
from sfft_jax.core.engine import GeneralSFFT
from sfft_jax.io import fits


class PureJAXCustomizedPacket:
    """Array-in/array-out customized subtraction (PureCupy packet analog)."""

    @staticmethod
    def PCP(
        PixA_REF,
        PixA_SCI,
        PixA_mREF,
        PixA_mSCI,
        ForceConv: str,
        GKerHW: int,
        KerPolyOrder: int = 2,
        BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True,
        cfg: Optional[SFFTConfig] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        assert ForceConv in ("REF", "SCI")
        PixA_REF = jnp.asarray(PixA_REF)
        PixA_SCI = jnp.asarray(PixA_SCI)
        PixA_mREF = jnp.asarray(PixA_mREF)
        PixA_mSCI = jnp.asarray(PixA_mSCI)

        if cfg is None:
            cfg = make_config(
                NX=PixA_REF.shape[0],
                NY=PixA_REF.shape[1],
                KerHW=GKerHW,
                KerPolyOrder=KerPolyOrder,
                BGPolyOrder=BGPolyOrder,
                ConstPhotRatio=ConstPhotRatio,
            )

        nan_u = jnp.isnan(PixA_REF) | jnp.isnan(PixA_SCI)

        if ForceConv == "REF":
            mI, mJ = PixA_mREF, PixA_mSCI
            I = jnp.where(nan_u, mI, PixA_REF)
            J = jnp.where(nan_u, mJ, PixA_SCI)
        else:
            mI, mJ = PixA_mSCI, PixA_mREF
            I = jnp.where(nan_u, mI, PixA_SCI)
            J = jnp.where(nan_u, mJ, PixA_REF)

        solution, diff, _ = GeneralSFFT.GSS(I, J, mI, mJ, cfg)
        diff = jnp.where(nan_u, jnp.nan, diff)
        if ForceConv == "SCI":
            diff = -diff
        return solution, diff


class CustomizedPacket:
    """FITS-level customized subtraction (reference Customized_Packet.CP)."""

    @staticmethod
    def CP(
        FITS_REF: str,
        FITS_SCI: str,
        FITS_mREF: str,
        FITS_mSCI: str,
        ForceConv: str,
        GKerHW: int,
        FITS_DIFF: Optional[str] = None,
        FITS_Solution: Optional[str] = None,
        KerPolyOrder: int = 2,
        BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True,
        cfg: Optional[SFFTConfig] = None,
        VERBOSE_LEVEL: int = 1,
    ):
        PixA_REF = fits.getdata(FITS_REF).T.astype(np.float64)
        PixA_SCI = fits.getdata(FITS_SCI).T.astype(np.float64)
        PixA_mREF = fits.getdata(FITS_mREF).T.astype(np.float64)
        PixA_mSCI = fits.getdata(FITS_mSCI).T.astype(np.float64)

        assert not np.isnan(PixA_mREF).any()
        assert not np.isnan(PixA_mSCI).any()

        if cfg is None:
            cfg = make_config(
                NX=PixA_REF.shape[0],
                NY=PixA_REF.shape[1],
                KerHW=GKerHW,
                KerPolyOrder=KerPolyOrder,
                BGPolyOrder=BGPolyOrder,
                ConstPhotRatio=ConstPhotRatio,
            )

        solution, diff = PureJAXCustomizedPacket.PCP(
            PixA_REF, PixA_SCI, PixA_mREF, PixA_mSCI, ForceConv, GKerHW, cfg=cfg
        )
        solution = np.asarray(solution)
        PixA_DIFF = np.asarray(diff)

        if FITS_DIFF is not None:
            _, sci_hdr = fits.read(FITS_SCI)
            hdr = fits.Header()
            for key, value, comment in sci_hdr.cards:
                hdr.add(key, value, comment)
            hdr.add("NAME_REF", pa.basename(FITS_REF), "MeLOn: SFFT")
            hdr.add("NAME_SCI", pa.basename(FITS_SCI), "MeLOn: SFFT")
            hdr.add("KERORDER", KerPolyOrder, "MeLOn: SFFT")
            hdr.add("BGORDER", BGPolyOrder, "MeLOn: SFFT")
            hdr.add("CPHOTR", str(ConstPhotRatio), "MeLOn: SFFT")
            hdr.add("KERHW", GKerHW, "MeLOn: SFFT")
            hdr.add("CONVD", ForceConv, "MeLOn: SFFT")
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)

        if FITS_Solution is not None:
            write_solution_fits(FITS_Solution, solution, cfg)

        return solution, PixA_DIFF


def write_solution_fits(path: str, solution: np.ndarray, cfg: SFFTConfig):
    """Solution FITS with the reference's header keys
    (sfft/CustomizedPacket.py:205-221) — the checkpoint format: readers can
    reconstruct kernels/backgrounds anywhere from this file alone."""
    hdr = fits.Header()
    hdr.add("N0", cfg.N0, "MeLOn: SFFT")
    hdr.add("N1", cfg.N1, "MeLOn: SFFT")
    if cfg.kernel_basis.kind == "polynomial":
        hdr.add("DK", cfg.kernel_basis.degree, "MeLOn: SFFT")
    if cfg.bg_basis.kind == "polynomial":
        hdr.add("DB", cfg.bg_basis.degree, "MeLOn: SFFT")
    hdr.add("L0", cfg.L0, "MeLOn: SFFT")
    hdr.add("L1", cfg.L1, "MeLOn: SFFT")
    hdr.add("FIJ", cfg.Fij, "MeLOn: SFFT")
    hdr.add("FAB", cfg.Fab, "MeLOn: SFFT")
    hdr.add("FPQ", cfg.Fpq, "MeLOn: SFFT")
    hdr.add("FIJAB", cfg.Fijab, "MeLOn: SFFT")
    fits.write(path, np.asarray(solution, np.float64).reshape(1, -1), hdr)
