"""Internal source extractor (SExtractor-equivalent fallback).

The reference shells out to the SExtractor binary through PY_SEx
(sfft/utils/pyAstroMatic/PYSEx.py). This environment has no `sex` binary, so
sfft_jax provides a built-in extractor producing the catalog columns the
pipelines consume (X_IMAGE, Y_IMAGE, FLUX_AUTO, FLUXERR_AUTO, MAG_AUTO,
MAGERR_AUTO, FLAGS, FLUX_RADIUS, FWHM_IMAGE, A_IMAGE, B_IMAGE, ELONGATION,
SNR_WIN) plus the SEGMENTATION check image. The wrapper in
sfft_jax/prep/sex.py prefers the real binary when present (bit-exact catalogs)
and falls back here.

Pipeline: mesh background -> matched-filter detection at DETECT_THRESH sigma
-> 8-connected labeling (native C++ ext) -> multi-threshold deblending
(exponential level ladder with the DEBLEND_MINCONT contrast criterion, pixels
reassigned to the nearest significant peak component) -> moment/photometric
measurements per object (Kron-style AUTO photometry, half-flux radius,
half-peak-area FWHM). FLAG bits: 2 (deblended), 4 (saturated),
8 (image-boundary truncation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi

from sfft_jax import native
from sfft_jax.prep.background import Background
from sfft_jax.utils.table import Table

# SExtractor 'default.conv' pyramid detection filter
_DEFAULT_FILTER = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]
) / 16.0


def _deblend_region(cut: np.ndarray, region: np.ndarray, floor: float,
                    nlevels: int = 32, mincont: float = 0.005):
    """Multi-threshold deblend of one labeled island.

    cut: background-subtracted pixels of the island's bounding box; region:
    boolean island mask; floor: the detection threshold level there.
    Returns a list of boolean sub-masks (len 1 = no split)."""
    vals = np.where(region, cut, 0.0)
    peak = float(vals.max())
    total = float(vals.sum())
    if peak <= 0 or total <= 0 or peak <= 2.0 * floor:
        return [region]

    best = None
    levels = floor * (peak / floor) ** (np.arange(1, nlevels) / nlevels)
    for lev in levels:
        sub = region & (cut > lev)
        lab, n = ndi.label(sub, structure=np.ones((3, 3)))
        if n < 2:
            continue
        fluxes = ndi.sum_labels(np.maximum(cut, 0.0), lab, np.arange(1, n + 1))
        sig = np.where(fluxes > mincont * total)[0] + 1
        if len(sig) >= 2 and (best is None or len(sig) > len(best[1])):
            best = (lab, sig)
    if best is None:
        return [region]

    lab, sig = best
    seeds = np.where(np.isin(lab, sig), lab, 0)
    # assign every island pixel to the nearest significant seed component
    _, (ix, iy) = ndi.distance_transform_edt(seeds == 0, return_indices=True)
    owner = seeds[ix, iy]
    return [region & (owner == s) for s in sig]


def extract_sources(
    image: np.ndarray,
    gain: float = 1.0,
    satur_level: float = 50000.0,
    back_type: str = "AUTO",
    back_value: float = 0.0,
    back_size: int = 64,
    back_filtersize: int = 3,
    detect_thresh: float = 1.5,
    detect_minarea: int = 5,
    detect_maxarea: int = 0,
    deblend_nlevels: int = 32,
    deblend_mincont: float = 0.005,
    use_filter: bool = True,
    mag_zeropoint: float = 0.0,
) -> Tuple[Table, np.ndarray]:
    """Returns (catalog Table, segmentation int32 map).

    Image axes follow the package convention: axis0 = X. X_IMAGE/Y_IMAGE are
    1-based FITS coordinates (X_IMAGE = axis0 index + 1).
    """
    img = np.asarray(image, dtype=np.float64)
    nanmask = ~np.isfinite(img)
    img = np.where(nanmask, 0.0, img)
    N0, N1 = img.shape

    if back_type == "AUTO":
        bkg = Background(np.where(nanmask, np.nan, img), bw=back_size,
                         bh=back_size, fw=back_filtersize, fh=back_filtersize)
        back = bkg.back()
        rms = bkg.rms()
    else:  # MANUAL
        back = np.full_like(img, back_value)
        bkg = Background(np.where(nanmask, np.nan, img), bw=back_size,
                         bh=back_size, fw=back_filtersize, fh=back_filtersize)
        rms = bkg.rms()
    rms = np.maximum(rms, 1e-10)

    sub = img - back
    det = ndi.convolve(sub / rms, _DEFAULT_FILTER, mode="nearest") if use_filter \
        else sub / rms
    mask = (det >= detect_thresh) & ~nanmask

    seg, nlab = native.label(mask, connectivity=2)
    if nlab == 0:
        return _empty_catalog(), seg

    sl = ndi.find_objects(seg)
    rows = {k: [] for k in [
        "X_IMAGE", "Y_IMAGE", "FLUX_AUTO", "FLUXERR_AUTO", "MAG_AUTO",
        "MAGERR_AUTO", "FLAGS", "FLUX_RADIUS", "FWHM_IMAGE", "A_IMAGE",
        "B_IMAGE", "THETA_IMAGE", "ELONGATION", "FLUX_ISO", "ISOAREA_IMAGE",
        "SNR_WIN", "FLUX_MAX", "SEGLABEL",
    ]}
    keep_labels = []
    newseg = np.zeros_like(seg)
    newlab = 0

    for lab in range(1, nlab + 1):
        s = sl[lab - 1]
        if s is None:
            continue
        island = seg[s] == lab
        if int(island.sum()) < detect_minarea:
            continue
        floor = detect_thresh * float(np.median(rms[s][island]))
        if deblend_mincont < 1.0:
            subregions = _deblend_region(sub[s], island, floor,
                                         nlevels=deblend_nlevels,
                                         mincont=deblend_mincont)
        else:
            subregions = [island]
        blended = len(subregions) > 1

        for region in subregions:
            area = int(region.sum())
            if area < detect_minarea:
                continue
            if detect_maxarea and area > detect_maxarea:
                continue
            cut = sub[s] * region
            flux_iso = float(cut.sum())
            if flux_iso <= 0:
                continue

            # barycenter + second moments (0-based local, then global)
            xs, ys = np.nonzero(region)
            w = np.maximum(cut[xs, ys], 0.0)
            if w.sum() <= 0:
                continue
            xbar = np.average(xs, weights=w)
            ybar = np.average(ys, weights=w)
            x2 = np.average((xs - xbar) ** 2, weights=w) + 1.0 / 12
            y2 = np.average((ys - ybar) ** 2, weights=w) + 1.0 / 12
            xy = np.average((xs - xbar) * (ys - ybar), weights=w)
            t1 = (x2 + y2) / 2
            t2 = np.sqrt(max(((x2 - y2) / 2) ** 2 + xy**2, 0.0))
            a2, b2 = max(t1 + t2, 1e-6), max(t1 - t2, 1e-6)
            A, B = np.sqrt(a2), np.sqrt(b2)
            theta = 0.5 * np.degrees(np.arctan2(2 * xy, x2 - y2))

            gx = xbar + s[0].start
            gy = ybar + s[1].start

            # AUTO (Kron) photometry on a circularized aperture
            r1 = _kron_radius(sub, gx, gy, A)
            r_auto = max(2.5 * r1, 3.5)  # SExtractor PHOT_AUTOPARAMS defaults
            flux_auto, fluxerr_auto, frad = _aperture_photometry(
                sub, rms, gx, gy, r_auto, gain
            )
            if flux_auto <= 0:
                flux_auto = flux_iso
            mag_auto = mag_zeropoint - 2.5 * np.log10(max(flux_auto, 1e-30))
            magerr_auto = 1.0857 * fluxerr_auto / max(flux_auto, 1e-30)

            # FWHM from the half-peak isophotal area (gaussian-core assumption)
            peak = cut.max()
            area_half = int((cut >= 0.5 * peak).sum())
            fwhm = 2.0 * np.sqrt(area_half / np.pi)

            flags = 2 if blended else 0
            if (img[s][region] >= satur_level).any():
                flags |= 4
            if (s[0].start == 0 or s[1].start == 0
                    or s[0].stop == N0 or s[1].stop == N1):
                flags |= 8

            newlab += 1
            newseg[s][region] = newlab
            keep_labels.append(lab)

            rows["X_IMAGE"].append(gx + 1.0)
            rows["Y_IMAGE"].append(gy + 1.0)
            rows["FLUX_AUTO"].append(flux_auto)
            rows["FLUXERR_AUTO"].append(fluxerr_auto)
            rows["MAG_AUTO"].append(mag_auto)
            rows["MAGERR_AUTO"].append(magerr_auto)
            rows["FLAGS"].append(flags)
            rows["FLUX_RADIUS"].append(frad)
            rows["FWHM_IMAGE"].append(fwhm)
            rows["A_IMAGE"].append(A)
            rows["B_IMAGE"].append(B)
            rows["THETA_IMAGE"].append(theta)
            rows["ELONGATION"].append(A / B)
            rows["FLUX_ISO"].append(flux_iso)
            rows["ISOAREA_IMAGE"].append(area)
            rows["SNR_WIN"].append(flux_auto / max(fluxerr_auto, 1e-30))
            rows["FLUX_MAX"].append(float(img[s][region].max()))
            rows["SEGLABEL"].append(newlab)

    cat = Table({k: np.asarray(v) for k, v in rows.items()})
    return cat, newseg


def _kron_radius(sub: np.ndarray, gx: float, gy: float, A: float) -> float:
    r_int = max(int(np.ceil(6 * max(A, 1.0))), 5)
    x0, x1 = int(max(0, gx - r_int)), int(min(sub.shape[0], gx + r_int + 1))
    y0, y1 = int(max(0, gy - r_int)), int(min(sub.shape[1], gy + r_int + 1))
    box = sub[x0:x1, y0:y1]
    xs, ys = np.mgrid[x0:x1, y0:y1]
    r = np.hypot(xs - gx, ys - gy)
    w = np.maximum(box, 0.0)
    inside = r <= r_int
    denom = w[inside].sum()
    if denom <= 0:
        return 1.0
    return float((w[inside] * r[inside]).sum() / denom)


def _aperture_photometry(sub, rms, gx, gy, r_ap, gain):
    r_int = int(np.ceil(r_ap)) + 1
    x0, x1 = int(max(0, gx - r_int)), int(min(sub.shape[0], gx + r_int + 1))
    y0, y1 = int(max(0, gy - r_int)), int(min(sub.shape[1], gy + r_int + 1))
    box = sub[x0:x1, y0:y1]
    rbox = rms[x0:x1, y0:y1]
    xs, ys = np.mgrid[x0:x1, y0:y1]
    r = np.hypot(xs - gx, ys - gy)
    inside = r <= r_ap
    flux = float(box[inside].sum())
    var = float((rbox[inside] ** 2).sum())
    if gain > 0 and flux > 0:
        var += flux / gain
    fluxerr = np.sqrt(max(var, 0.0))

    # half-flux radius from the curve of growth
    if flux > 0:
        order = np.argsort(r[inside])
        cum = np.cumsum(box[inside][order])
        hidx = np.searchsorted(cum, 0.5 * flux)
        frad = float(np.sort(r[inside])[min(hidx, len(cum) - 1)])
    else:
        frad = 1.0
    return flux, fluxerr, frad


def _empty_catalog() -> Table:
    keys = ["X_IMAGE", "Y_IMAGE", "FLUX_AUTO", "FLUXERR_AUTO", "MAG_AUTO",
            "MAGERR_AUTO", "FLAGS", "FLUX_RADIUS", "FWHM_IMAGE", "A_IMAGE",
            "B_IMAGE", "THETA_IMAGE", "ELONGATION", "FLUX_ISO",
            "ISOAREA_IMAGE", "SNR_WIN", "FLUX_MAX", "SEGLABEL"]
    return Table({k: np.array([]) for k in keys})
