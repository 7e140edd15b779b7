"""Minimal FITS WCS: TAN and TPV (polynomial-distorted TAN) projections.

astropy is unavailable in this environment; the reference's WCS consumers
(Read_WCS, PatternRotation_Calculator, Sky_Symmetric_Match, PYSWarp
resampling, ImageZoomRotate) only need pixel<->world transforms for
TAN/TPV headers with CD or CDELT+PC linear terms
(sfft/utils/ReadWCS.py:8-121 documents exactly these cases).

Interface mirrors astropy.wcs.WCS: all_pix2world / all_world2pix with a FITS
`origin` argument (1 = FortranCoor).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

D2R = np.pi / 180.0


def _tpv_poly(pv: dict, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Standard TPV polynomial: PV terms 0..38 in (x, y, r)."""
    r = np.sqrt(x**2 + y**2)
    terms = [
        np.ones_like(x), x, y, r,
        x**2, x * y, y**2,
        x**3, x**2 * y, x * y**2, y**3, r**3,
        x**4, x**3 * y, x**2 * y**2, x * y**3, y**4,
        x**5, x**4 * y, x**3 * y**2, x**2 * y**3, x * y**4, y**5, r**5,
    ]
    out = np.zeros_like(x)
    for k, t in enumerate(terms):
        c = pv.get(k)
        if c:
            out = out + c * t
    return out


class WCS:
    def __init__(self, hdr):
        self.ctype1 = str(hdr.get("CTYPE1", "RA---TAN")).strip()
        self.ctype2 = str(hdr.get("CTYPE2", "DEC--TAN")).strip()
        self.crpix = np.array([float(hdr.get("CRPIX1", 0.0)),
                               float(hdr.get("CRPIX2", 0.0))])
        self.crval = np.array([float(hdr.get("CRVAL1", 0.0)),
                               float(hdr.get("CRVAL2", 0.0))])
        if "CD1_1" in hdr:
            self.cd = np.array([
                [float(hdr.get("CD1_1", 0.0)), float(hdr.get("CD1_2", 0.0))],
                [float(hdr.get("CD2_1", 0.0)), float(hdr.get("CD2_2", 0.0))],
            ])
        else:
            cdelt = np.array([float(hdr.get("CDELT1", 1.0)),
                              float(hdr.get("CDELT2", 1.0))])
            pc = np.array([
                [float(hdr.get("PC1_1", 1.0)), float(hdr.get("PC1_2", 0.0))],
                [float(hdr.get("PC2_1", 0.0)), float(hdr.get("PC2_2", 1.0))],
            ])
            self.cd = pc * cdelt[:, None]
        # TPV distortion (also the obsolete TAN+PV convention)
        self.pv1 = {}
        self.pv2 = {}
        for key in getattr(hdr, "keys", lambda: [])():
            if key.startswith("PV1_"):
                self.pv1[int(key[4:])] = float(hdr[key])
            elif key.startswith("PV2_"):
                self.pv2[int(key[4:])] = float(hdr[key])
        self.has_pv = bool(self.pv1 or self.pv2)
        if not self.pv1:
            self.pv1 = {1: 1.0}
        if not self.pv2:
            self.pv2 = {1: 1.0}

    # -- pixel -> intermediate (deg) ------------------------------------
    def _pix2xy(self, pix: np.ndarray) -> np.ndarray:
        d = pix - self.crpix
        xy = d @ self.cd.T
        if self.has_pv:
            x, y = xy[:, 0], xy[:, 1]
            # TPV: axis1 poly in (x, y), axis2 poly in (y, x)
            xi = _tpv_poly(self.pv1, x, y)
            eta = _tpv_poly(self.pv2, y, x)
            return np.stack([xi, eta], axis=1)
        return xy

    def _xy2pix(self, xy: np.ndarray) -> np.ndarray:
        if self.has_pv:
            # Newton iterations for the distortion inverse
            guess = xy.copy()
            for _ in range(30):
                cur = np.stack([
                    _tpv_poly(self.pv1, guess[:, 0], guess[:, 1]),
                    _tpv_poly(self.pv2, guess[:, 1], guess[:, 0]),
                ], axis=1)
                err = xy - cur
                if np.max(np.abs(err)) < 1e-12:
                    break
                # numerical jacobian (diagonal-dominant; damped update)
                eps = 1e-7
                j11 = (_tpv_poly(self.pv1, guess[:, 0] + eps, guess[:, 1])
                       - cur[:, 0]) / eps
                j12 = (_tpv_poly(self.pv1, guess[:, 0], guess[:, 1] + eps)
                       - cur[:, 0]) / eps
                j21 = (_tpv_poly(self.pv2, guess[:, 1], guess[:, 0] + eps)
                       - cur[:, 1]) / eps
                j22 = (_tpv_poly(self.pv2, guess[:, 1] + eps, guess[:, 0])
                       - cur[:, 1]) / eps
                det = j11 * j22 - j12 * j21
                det = np.where(np.abs(det) < 1e-30, 1e-30, det)
                dx = (j22 * err[:, 0] - j12 * err[:, 1]) / det
                dy = (-j21 * err[:, 0] + j11 * err[:, 1]) / det
                guess = guess + np.stack([dx, dy], axis=1)
            xy = guess
        inv = np.linalg.inv(self.cd)
        return xy @ inv.T + self.crpix

    # -- intermediate (deg) <-> sky: TAN (de)projection -----------------
    def _xy2world(self, xy: np.ndarray) -> np.ndarray:
        xi = xy[:, 0] * D2R
        eta = xy[:, 1] * D2R
        ra0 = self.crval[0] * D2R
        dec0 = self.crval[1] * D2R
        den = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, den)
        dec = np.arctan((np.sin(dec0) + eta * np.cos(dec0))
                        / np.sqrt(xi**2 + den**2))
        return np.stack([np.degrees(ra) % 360.0, np.degrees(dec)], axis=1)

    def _world2xy(self, rd: np.ndarray) -> np.ndarray:
        ra = rd[:, 0] * D2R
        dec = rd[:, 1] * D2R
        ra0 = self.crval[0] * D2R
        dec0 = self.crval[1] * D2R
        cosc = (np.sin(dec0) * np.sin(dec)
                + np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0))
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc
        eta = (np.cos(dec0) * np.sin(dec)
               - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc
        return np.degrees(np.stack([xi, eta], axis=1))

    # -- public astropy-like API ----------------------------------------
    def all_pix2world(self, pix, origin: int = 1) -> np.ndarray:
        # internal math uses the FITS 1-based convention (CRPIX is 1-based)
        pix = np.atleast_2d(np.asarray(pix, dtype=np.float64)) + (1 - origin)
        return self._xy2world(self._pix2xy(pix))

    def all_world2pix(self, rd, origin: int = 1) -> np.ndarray:
        rd = np.atleast_2d(np.asarray(rd, dtype=np.float64))
        return self._xy2pix(self._world2xy(rd)) - (1 - origin)


class ReadWCS:
    """Reference Read_WCS.RW facade (TPV fix applied automatically)."""

    @staticmethod
    def RW(hdr, VERBOSE_LEVEL: int = 1) -> WCS:
        return WCS(hdr)


class CombineHeader:
    """Replace the WCS cards of a base header with another header's
    (reference Combine_Header.CH, sfft/utils/CombineHeader.py)."""

    WCS_KEYS = ("CTYPE1", "CTYPE2", "CRPIX1", "CRPIX2", "CRVAL1", "CRVAL2",
                "CD1_1", "CD1_2", "CD2_1", "CD2_2", "CDELT1", "CDELT2",
                "PC1_1", "PC1_2", "PC2_1", "PC2_2", "CUNIT1", "CUNIT2",
                "EQUINOX", "RADESYS")

    @staticmethod
    def CH(hdr_base, hdr_wcs):
        from sfft_jax.io.fits import Header

        out = Header()
        for key, value, comment in hdr_base.cards:
            if key in CombineHeader.WCS_KEYS or key.startswith("PV"):
                continue
            out.add(key, value, comment)
        for key, value, comment in hdr_wcs.cards:
            if key in CombineHeader.WCS_KEYS or key.startswith("PV"):
                out.add(key, value, comment)
        return out


class PatternRotationCalculator:
    """Sky-north rotation angle between two WCS frames
    (reference PatternRotation_Calculator.PRC)."""

    @staticmethod
    def PRC(hdr_obj, hdr_targ) -> float:
        def skyN_vector(hdr, x_start, y_start, shift_dec=1.0):
            w = ReadWCS.RW(hdr)
            ra0, dec0 = w.all_pix2world(np.array([[x_start, y_start]]), 1)[0]
            x_end, y_end = w.all_world2pix(
                np.array([[ra0, dec0 + shift_dec / 3600.0]]), 1)[0]
            return np.array([x_end - x_start, y_end - y_start])

        w = ReadWCS.RW(hdr_obj)
        x0 = 0.5 + int(hdr_obj["NAXIS1"]) / 2.0
        y0 = 0.5 + int(hdr_obj["NAXIS2"]) / 2.0
        ra0, dec0 = w.all_pix2world(np.array([[x0, y0]]), 1)[0]
        v_ref = skyN_vector(hdr_obj, x0, y0)

        wt = ReadWCS.RW(hdr_targ)
        x1, y1 = wt.all_world2pix(np.array([[ra0, dec0]]), 1)[0]
        v_obj = skyN_vector(hdr_targ, x1, y1)

        cross = v_ref[0] * v_obj[1] - v_ref[1] * v_obj[0]
        rad = np.arctan2(cross, np.dot(v_ref, v_obj))
        angle = np.rad2deg(rad)
        if angle < 0.0:
            angle += 360.0
        return float(angle)


class NeighboringPixelCovariance:
    """25-offset pixel covariance matrix + scalar covariance level
    (reference NeighboringPixel_Covariance.NPC)."""

    RVS = ([0, 0],
           [1, 0], [-1, 0], [0, 1], [0, -1],
           [1, 1], [1, -1], [-1, 1], [-1, -1],
           [2, 0], [-2, 0], [0, 2], [0, -2],
           [3, 0], [-3, 0], [0, 3], [0, -3],
           [4, 0], [-4, 0], [0, 4], [0, -4],
           [5, 0], [-5, 0], [0, 5], [0, -5])

    @staticmethod
    def NPC(PixA_obj: np.ndarray):
        im = PixA_obj / PixA_obj.std()
        shifted, rejs = [], []
        for p, q in NeighboringPixelCovariance.RVS:
            s = np.roll(np.roll(im, p, axis=0), q, axis=1)
            rej = np.zeros(im.shape, bool)
            if p > 0:
                rej[:p, :] = True
            if p < 0:
                rej[p:, :] = True
            if q > 0:
                rej[:, :q] = True
            if q < 0:
                rej[:, q:] = True
            shifted.append(s)
            rejs.append(rej)
        rmask = np.logical_or.reduce(tuple(rejs))
        samples = np.array([s[~rmask].ravel() for s in shifted])
        cov = np.cov(samples, bias=True)
        tmp = cov.copy()
        np.fill_diagonal(tmp, np.nan)
        level = float(np.nansum(np.abs(tmp)) / np.sum(np.diag(cov)))
        return cov, level
