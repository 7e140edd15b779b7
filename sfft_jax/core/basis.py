"""Spatial basis evaluation: polynomial and B-spline, separable 1D x 1D form.

Reference equivalents: SpatialCoor / SpatialPoly CUDA+numba kernels
(sfft/sfftcore/SFFTConfigure.py:81-145, 886-937) and Create_BSplineBasis
(sfft/BSplineSFFT.py:2624-2645).

Design: every supported basis function is separable,
B_k(x, y) = u_{i_k}(cx) * v_{j_k}(cy), so we only ever materialize the 1D value
tables U (N0, F1d) and V (N1, F1d) as small constants and form planes by outer
product inside the jitted graph — no (F, N0, N1) host constants are baked in.

Coordinates are ScaledFortranCoor: cx = (row + 1) / N0, cy = (col + 1) / N1
(reference: sfft/sfftcore/SFFTSubtract.py:545-560).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from sfft_jax.config import BasisSpec
from sfft_jax.core.indices import ref_basis_exponents


def scaled_coords_1d(N: int, dtype=np.float64) -> np.ndarray:
    """cx = (idx + 1) / N for idx in [0, N)."""
    return ((np.arange(N, dtype=np.float64) + 1.0) / N).astype(dtype)


@lru_cache(maxsize=64)
def basis_1d_tables(spec: BasisSpec, N0: int, N1: int) -> Tuple[np.ndarray, np.ndarray]:
    """1D basis value tables (U: (N0, F0), V: (N1, F1)) on the host.

    polynomial: U[:, i] = cx^i for i in 0..degree (triangular pairing handled by
    the exponent table). bspline: clamped B-spline basis values with knot vector
    ([0.5]*(k+1) + int_knots + [N+0.5]*(k+1)) / N evaluated at cx, matching the
    reference's scipy construction (sfft/BSplineSFFT.py:2624-2645).
    """
    cx = scaled_coords_1d(N0)
    cy = scaled_coords_1d(N1)
    if spec.kind == "polynomial":
        d = spec.degree
        U = np.stack([cx**i for i in range(d + 1)], axis=1)
        V = np.stack([cy**j for j in range(d + 1)], axis=1)
        return U, V
    if spec.kind == "bspline":
        U = _bspline_basis_values(cx, spec.int_knots_x, spec.degree, N0)
        V = _bspline_basis_values(cy, spec.int_knots_y, spec.degree, N1)
        return U, V
    raise ValueError(spec.kind)


def _bspline_basis_values(
    c: np.ndarray, int_knots: Tuple[float, ...], degree: int, N: int
) -> np.ndarray:
    """Values of all clamped B-spline basis functions at scaled coords c.

    Knots in pixel units: [0.5]*(k+1) + int_knots + [N+0.5]*(k+1), scaled by 1/N
    so that the domain is the ScaledFortranCoor interval [0.5/N, 1 + 0.5/N].
    """
    from scipy.interpolate import BSpline

    k = degree
    knots = np.concatenate(
        [np.full(k + 1, 0.5), np.asarray(int_knots, dtype=np.float64), np.full(k + 1, N + 0.5)]
    ) / float(N)
    nfun = len(knots) - k - 1
    out = np.zeros((len(c), nfun), dtype=np.float64)
    for m in range(nfun):
        coef = np.zeros(nfun)
        coef[m] = 1.0
        out[:, m] = BSpline(knots, coef, k, extrapolate=False)(c)
    out = np.nan_to_num(out, nan=0.0)
    return out


def basis_planes(spec: BasisSpec, N0: int, N1: int, dtype=jnp.float64) -> jnp.ndarray:
    """In-graph (F, N0, N1) basis plane stack via 1D outer products."""
    U, V = basis_1d_tables(spec, N0, N1)
    exps = ref_basis_exponents(spec)
    Uj = jnp.asarray(U[:, exps[:, 0]], dtype=dtype)  # (N0, F)
    Vj = jnp.asarray(V[:, exps[:, 1]], dtype=dtype)  # (N1, F)
    return jnp.einsum("xf,yf->fxy", Uj, Vj)


def basis_at_points(spec: BasisSpec, N0: int, N1: int, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Host-side basis values at ScaledFortranCoor query points (for kernel /
    flux-scaling realization; reference Realize_MatchingKernel
    sfft/utils/SFFTSolutionReader.py:116-151)."""
    exps = ref_basis_exponents(spec)
    if spec.kind == "polynomial":
        return np.stack([sx ** i * sy ** j for (i, j) in exps], axis=0)
    if spec.kind == "bspline":
        Uq = _bspline_basis_values(np.asarray(sx, np.float64), spec.int_knots_x, spec.degree, N0)
        Vq = _bspline_basis_values(np.asarray(sy, np.float64), spec.int_knots_y, spec.degree, N1)
        return np.stack([Uq[:, i] * Vq[:, j] for (i, j) in exps], axis=0)
    raise ValueError(spec.kind)
