"""Static multi-index tables for normal-equation assembly.

The reference builds these on the fly per solve (sfft/sfftcore/SFFTSubtract.py:
513-532). Here they are plain numpy arrays computed once per SFFTConfig and
baked into the jitted computation as constants — the analog of the
reference's runtime-generated CUDA kernels that inline the same integers.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from sfft_jax.config import BasisSpec, SFFTConfig


def ref_basis_exponents(spec: BasisSpec) -> np.ndarray:
    """Multi-index (i, j) list for a basis spec.

    polynomial: triangular order [(i, j) for i in 0..D for j in 0..D-i]
    (reference: sfft/sfftcore/SFFTSubtract.py:515); bspline: full tensor raster
    [(i, j) for i in 0..Fi for j in 0..Fj] (reference: sfft/BSplineSFFT.py).
    """
    if spec.kind == "polynomial":
        d = spec.degree
        return np.array(
            [(i, j) for i in range(d + 1) for j in range(d + 1 - i)], dtype=np.int32
        )
    if spec.kind == "bspline":
        fi = len(spec.int_knots_x) + spec.degree + 1
        fj = len(spec.int_knots_y) + spec.degree + 1
        return np.array([(i, j) for i in range(fi) for j in range(fj)], dtype=np.int32)
    raise ValueError(spec.kind)


def ref_ab(w0: int, w1: int) -> np.ndarray:
    """Kernel pixel offsets (a, b) in raster order, a in [-w0, w0], b in [-w1, w1].

    Matches reference REF_ab ordering (sfft/sfftcore/SFFTSubtract.py:516).
    """
    L0, L1 = 2 * w0 + 1, 2 * w1 + 1
    return np.array(
        [(ap - w0, bp - w1) for ap in range(L0) for bp in range(L1)], dtype=np.int32
    )


@lru_cache(maxsize=64)
def stripe_indices(cfg: SFFTConfig) -> np.ndarray:
    """Indices of the NEQ system kept when ConstPhotRatio removes the
    "forbidden stripes" — the kernel-sum dof a_{ij,(0,0)} for every non-constant
    spatial term ij >= 1 (reference: sfft/sfftcore/SFFTSubtract.py:525-532)."""
    neq = cfg.NEQ
    if not cfg.const_phot_ratio:
        return np.arange(neq, dtype=np.int32)
    ij00 = np.arange(cfg.center_ab, cfg.Fijab, cfg.Fab)
    forbidden = ij00[1:]
    mask = np.ones(neq, dtype=bool)
    mask[forbidden] = False
    return np.where(mask)[0].astype(np.int32)


@lru_cache(maxsize=64)
def ab_tables(cfg: SFFTConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(a_vec, b_vec, nonzero) per flat ab index."""
    ab = ref_ab(cfg.w0, cfg.w1)
    a, b = ab[:, 0], ab[:, 1]
    nz = (a != 0) | (b != 0)
    return a, b, nz


def kernel_sum_dof_index(cfg: SFFTConfig) -> np.ndarray:
    """Flat solution indices of a_{ij,(0,0)} for each ij (flux-scaling dof)."""
    return (np.arange(cfg.Fij) * cfg.Fab + cfg.center_ab).astype(np.int32)
