"""Straight-line Hough transform + peak finding + detection driver.

Reference: vendored skimage-0.18.3 hough_line/hough_line_peaks
(sfft/utils/houghLine/) and Hough_Detection (sfft/utils/HoughDetection.py).
The reference pins skimage 0.16-0.18 binning semantics (the rho-bias behavior
changed in 0.19; sfft/utils/HoughDetection.py:73-101) — this implementation
reproduces the 0.16-0.18 convention: accumulator size 2*ceil(hypot(M, N)),
bins = linspace(-D/2, D/2, D), index = round_half_away(cos*x + sin*y) + D//2.
"""

from __future__ import annotations

import bisect
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi

from sfft_jax import native


def hough_line(image: np.ndarray, theta: Optional[np.ndarray] = None):
    if image.ndim != 2:
        raise ValueError("input image must be 2D")
    if theta is None:
        theta = np.linspace(-np.pi / 2, np.pi / 2, 180)
    max_distance = 2 * int(
        np.ceil(np.sqrt(image.shape[0] ** 2 + image.shape[1] ** 2))
    )
    bins = np.linspace(-max_distance / 2.0, max_distance / 2.0, max_distance)
    y_idxs, x_idxs = np.nonzero(image)
    accum = native.hough_accum(
        x_idxs, y_idxs, np.cos(theta), np.sin(theta), max_distance
    )
    return accum, theta, bins


def _prominent_peaks(image, min_xdistance=1, min_ydistance=1, threshold=None,
                     num_peaks=np.inf):
    """Non-maximum-suppressed peaks (vendored-skimage behavior,
    sfft/utils/houghLine/peak.py:6-106)."""
    img = image.astype(np.float64).copy()
    rows, cols = img.shape
    if threshold is None:
        threshold = 0.5 * np.max(img)

    img_max = ndi.maximum_filter1d(img, size=2 * min_ydistance + 1, axis=0,
                                   mode="constant", cval=0)
    img_max = ndi.maximum_filter1d(img_max, size=2 * min_xdistance + 1, axis=1,
                                   mode="constant", cval=0)
    mask = img == img_max
    img = img * mask
    img_t = img > threshold

    lab, n = native.label(img_t, connectivity=2)
    if n == 0:
        return np.array([]), np.array([], int), np.array([], int)
    # per-label max intensity of img_max and centroid
    idx = np.arange(1, n + 1)
    maxint = ndi.labeled_comprehension(img_max, lab, idx, np.max, float, 0.0)
    cents = ndi.center_of_mass(np.ones(lab.shape), lab, idx)
    order = np.argsort(maxint)[::-1]
    coords = np.array([np.round(cents[k]) for k in order], dtype=int)

    img_peaks, yc_peaks, xc_peaks = [], [], []
    ycoords_ext, xcoords_ext = np.mgrid[-min_ydistance : min_ydistance + 1,
                                        -min_xdistance : min_xdistance + 1]
    for yi, xi in coords:
        accum = img_max[yi, xi]
        if accum > threshold:
            ynh = yi + ycoords_ext
            xnh = xi + xcoords_ext
            yin = np.logical_and(ynh > 0, ynh < rows)
            ynh = ynh[yin]
            xnh = xnh[yin]
            xlow = xnh < 0
            ynh[xlow] = rows - ynh[xlow]
            xnh[xlow] += cols
            xhigh = xnh >= cols
            ynh[xhigh] = rows - ynh[xhigh]
            xnh[xhigh] -= cols
            img_max[ynh, xnh] = 0
            img_peaks.append(accum)
            yc_peaks.append(yi)
            xc_peaks.append(xi)

    img_peaks = np.array(img_peaks)
    yc_peaks = np.array(yc_peaks, int)
    xc_peaks = np.array(xc_peaks, int)
    if num_peaks < len(img_peaks):
        sel = np.argsort(img_peaks)[::-1][: int(num_peaks)]
        img_peaks, yc_peaks, xc_peaks = img_peaks[sel], yc_peaks[sel], xc_peaks[sel]
    return img_peaks, xc_peaks, yc_peaks


def hough_line_peaks(hspace, angles, dists, min_distance=9, min_angle=10,
                     threshold=None, num_peaks=np.inf):
    min_angle = min(min_angle, hspace.shape[1])
    h, a, d = _prominent_peaks(
        hspace, min_xdistance=min_angle, min_ydistance=min_distance,
        threshold=threshold, num_peaks=num_peaks,
    )
    if len(a) and a.any():
        return h, angles[a], dists[d]
    return h, np.array([]), np.array([])


class HoughDetection:
    """Reference Hough_Detection.HD: scatter -> 2D histogram pixelization ->
    threshold/canny mask -> hough peaks -> back-transform + point-line
    distances (sfft/utils/HoughDetection.py:106-157)."""

    @staticmethod
    def HD(XY_obj=None, PixA_obj=None, Hmask=None, grid_pixsize=None,
           count_thresh=None, canny_sig=None, peak_clip=0.7):
        if XY_obj is not None:
            XY_h = XY_obj if Hmask is None else XY_obj[Hmask]
            x_min, x_max = XY_h[:, 0].min(), XY_h[:, 0].max()
            y_min, y_max = XY_h[:, 1].min(), XY_h[:, 1].max()
            xnodes = np.arange(x_min, x_max + 2 * grid_pixsize, grid_pixsize)
            ynodes = np.arange(y_min, y_max + 2 * grid_pixsize, grid_pixsize)
            PixA_inp = np.zeros((len(xnodes) - 1, len(ynodes) - 1))
            for x, y in XY_h:
                r = bisect.bisect_right(xnodes, x) - 1
                c = bisect.bisect_right(ynodes, y) - 1
                PixA_inp[r, c] += 1
        else:
            assert PixA_obj is not None
            PixA_inp = PixA_obj

        assert (count_thresh is not None) or (canny_sig is not None)
        if count_thresh is not None:
            Mask_inp = PixA_inp >= count_thresh
        else:
            from sfft_jax.utils.canny import canny

            Mask_inp = canny(PixA_inp, sigma=canny_sig)

        Hspace, Theta, Rho = hough_line(Mask_inp.astype(int))
        ThetaPeaks, RhoPeaks = hough_line_peaks(
            Hspace, Theta, Rho, threshold=peak_clip * np.max(Hspace)
        )[1:]

        ScaLineDIST = None
        if XY_obj is not None:
            ScaLineDIST = []
            RhoPeaks = np.array(RhoPeaks, dtype=np.float64)
            for i in range(len(RhoPeaks)):
                RhoPeaks[i] = (grid_pixsize * RhoPeaks[i]
                               + x_min * np.sin(ThetaPeaks[i])
                               + y_min * np.cos(ThetaPeaks[i]))
                dist = np.abs(np.sin(ThetaPeaks[i]) * XY_obj[:, 0]
                              + np.cos(ThetaPeaks[i]) * XY_obj[:, 1]
                              - RhoPeaks[i])
                ScaLineDIST.append(dist)
            ScaLineDIST = np.array(ScaLineDIST).T
        return PixA_inp, Hspace, ThetaPeaks, RhoPeaks, ScaLineDIST
