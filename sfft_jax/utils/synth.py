"""Seeded synthetic image pairs for smoke runs, benchmarks and tests.

A pair is a star field seen through two slightly different Gaussian PSFs on
a sky gradient, with unit Gaussian noise: the science image J is the
reference I convolved with a narrow positive kernel, scaled by a photometric
ratio, plus a constant background offset. Values are O(1e2 - 1e3) counts with
sigma = 1 noise, which is the regime the SFFT normal equations are built for.
Everything is float64 numpy on the host and depends only on the arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _gaussian_otf(n0: int, n1: int, sigma: float) -> np.ndarray:
    """rfft2 of a unit-sum circular Gaussian PSF centred on pixel (0, 0)."""
    u = np.fft.fftfreq(n0)[:, None]
    v = np.fft.rfftfreq(n1)[None, :]
    return np.exp(-2.0 * (np.pi * sigma) ** 2 * (u * u + v * v))


def star_pair(
    n0: int,
    n1: int,
    seed: int = 0,
    sigma_ref: float = 1.6,
    sigma_sci: float = 2.0,
    flux_ratio: float = 1.1,
    bg_offset: float = 5.0,
    stars_per_kpix: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """(I, J): seeded (n0, n1) reference and science images.

    Stars sit at uniform positions with log-uniform fluxes 1e2..1e5 and are
    convolved (circularly, via FFT) with a Gaussian of width sigma_ref for I
    and sigma_sci for J. Both share the sky 100 + 20 x/n0 + 10 (y/n1)^2; J
    carries flux_ratio times the scene plus bg_offset."""
    rng = np.random.default_rng(seed)
    n_stars = max(8, int(stars_per_kpix * n0 * n1 / 1000))
    pts = np.zeros((n0, n1))
    xs = rng.integers(0, n0, n_stars)
    ys = rng.integers(0, n1, n_stars)
    np.add.at(pts, (xs, ys), 10.0 ** rng.uniform(2.0, 5.0, n_stars))
    spec = np.fft.rfft2(pts)
    stars_I = np.fft.irfft2(spec * _gaussian_otf(n0, n1, sigma_ref), s=(n0, n1))
    stars_J = np.fft.irfft2(spec * _gaussian_otf(n0, n1, sigma_sci), s=(n0, n1))
    x = (np.arange(n0)[:, None] + 1.0) / n0
    y = (np.arange(n1)[None, :] + 1.0) / n1
    sky = 100.0 + 20.0 * x + 10.0 * y * y
    I = stars_I + sky + rng.normal(0.0, 1.0, (n0, n1))
    J = flux_ratio * (stars_J + sky) + bg_offset + rng.normal(0.0, 1.0, (n0, n1))
    return I, J


def nircam_bspline_kwargs(n0: int, n1: int, seed: int = 10086) -> dict:
    """make_bspline_config keyword arguments of the JWST/NIRCam 900^2 stamp
    setup: degree-2 B-spline kernel with 2x2 interior knots, separate
    degree-2 polynomial flux scaling, a constant background, and Tikhonov
    regularization (lambda 3e-5) at 512 seeded positions. Use with
    GKerHW=11 (13,226 unknowns at 900^2)."""
    rng = np.random.default_rng(seed)
    xy_reg = np.stack([rng.uniform(10.0, n0 - 10.0, 512),
                       rng.uniform(10.0, n1 - 10.0, 512)], axis=1)
    return dict(
        KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[0.5 + n0 / 3, 0.5 + n0 * 2 / 3],
        KerIntKnotY=[0.5 + n1 / 3, 0.5 + n1 * 2 / 3],
        SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
        BkgSpType="Polynomial", BkgSpDegree=0,
        REGULARIZE_KERNEL=True, XY_REGULARIZE=xy_reg, LAMBDA_REGULARIZE=3e-5)
