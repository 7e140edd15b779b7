"""The SFFT engine: configure -> jitted solve & subtract.

Maps to the reference call stack ElementalSFFTSubtract.ESS /
GeneralSFFTSubtract.GSS (sfft/sfftcore/SFFTSubtract.py:8-475, 823-923), but as
two pure jitted functions cached per static SFFTConfig — the jit trace cache
plays the role of the reference's per-config nvcc RawModule dict.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sfft_jax.config import SFFTConfig
from sfft_jax.core.assemble import assemble_system
from sfft_jax.core.basis import basis_planes
from sfft_jax.core.fdiff import fdiff
from sfft_jax.core.greek import greek_tables
from sfft_jax.core.solve import solve_system


def _plane_stacks(cfg: SFFTConfig, I: jnp.ndarray, dtype=None):
    """SI = I * kernel-basis planes (reference SPixA_Iij); ST = background basis
    planes (reference SPixA_Tpq); SSc = I * scaling-basis planes, zero-padded to
    Fij, for SEPARATE-VARYING (reference ScaSPixA_Iij)."""
    dt = jnp.dtype(cfg.dtype) if dtype is None else jnp.dtype(dtype)
    Bk = basis_planes(cfg.kernel_basis, cfg.N0, cfg.N1, dtype=dt)
    ST = basis_planes(cfg.bg_basis, cfg.N0, cfg.N1, dtype=dt)
    SI = I[None, :, :].astype(dt) * Bk
    SSc = None
    if cfg.scaling_mode == "SEPARATE-VARYING":
        Bs = basis_planes(cfg.scaling_basis, cfg.N0, cfg.N1, dtype=dt)
        SSc = I[None, :, :].astype(dt) * Bs
        if SSc.shape[0] < cfg.Fij:
            pad = jnp.zeros((cfg.Fij - SSc.shape[0], cfg.N0, cfg.N1), dt)
            SSc = jnp.concatenate([SSc, pad], axis=0)
    return SI, ST, SSc


def _normal_equations_impl(cfg: SFFTConfig, mI: jnp.ndarray, mJ: jnp.ndarray,
                           shared=None):
    """Assemble the (NEQ, NEQ) normal-equation matrix and RHS vector for a
    masked pair — everything `_solve_impl` does short of the solve. Exposed
    (via `normal_equations_fn`) so the benchmark can compute residual
    certificates ||LH.x - RH|| of candidate solutions on one shared f64
    table set (reference LHMAT/RHb, sfft/sfftcore/SFFTSubtract.py:224-383)."""
    from sfft_jax.core.assemble import entangled_tables, GreekTables

    dt = jnp.dtype(cfg.dtype)
    mI = mI.astype(dt)
    mJ = mJ.astype(dt)
    s = cfg.SCALE
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"

    if cfg.greek_backend in ("peeled", "exact", "pexact"):
        if cfg.greek_backend == "peeled":
            from sfft_jax.core.peel import peeled_greek_tables

            out = peeled_greek_tables(mI, mJ, cfg)
        elif cfg.greek_backend == "pexact":
            from sfft_jax.core.pexact import pexact_greek_tables

            out = pexact_greek_tables(mI, mJ, cfg, shared=shared)
        else:
            from sfft_jax.core.greek import greek_tables_exact

            out = greek_tables_exact(mI, mJ, cfg, shared=shared)
        Comg, Cgam, Cthe, Cphi, Cdel = out[:5]
        tables = entangled_tables(
            cfg, (s**3) * Comg, (s**2) * Cgam, (s**2) * Cthe, s * Cphi, s * Cdel
        )
        if separate_varying:
            Pbs, Pss, Pgs, Pts = out[5]
            tables = GreekTables(
                Pbb=tables.Pbb, Pbs=(s**3) * Pbs, Pss=(s**3) * Pss,
                Pgb=tables.Pgb, Pgs=(s**2) * Pgs,
                Ptb=tables.Ptb, Pts=(s**2) * Pts,
                Pphi=tables.Pphi, Pdel=tables.Pdel,
            )
    else:
        SI, ST, SSc = _plane_stacks(cfg, mI)
        Comg, Cgam, Cthe, Cphi, Cdel = greek_tables(
            SI, ST, mJ, cfg.w0, cfg.w1, backend=cfg.greek_backend,
            chunk=cfg.greek_chunk, bg_spec=cfg.bg_basis,
        )
        tables = entangled_tables(
            cfg, (s**3) * Comg, (s**2) * Cgam, (s**2) * Cthe, s * Cphi, s * Cdel
        )
        if separate_varying:
            from sfft_jax.core.greek import greek_tables_separate

            Pbs, Pss, Pgs, Pts = greek_tables_separate(
                SI, SSc, ST, mJ, cfg.w0, cfg.w1,
                backend=cfg.greek_backend, chunk=cfg.greek_chunk,
                bg_spec=cfg.bg_basis,
                n_active=cfg.scaling_basis.num_funcs(),
            )
            tables = GreekTables(
                Pbb=tables.Pbb, Pbs=(s**3) * Pbs, Pss=(s**3) * Pss,
                Pgb=tables.Pgb, Pgs=(s**2) * Pgs,
                Ptb=tables.Ptb, Pts=(s**2) * Pts,
                Pphi=tables.Pphi, Pdel=tables.Pdel,
            )

    from sfft_jax.core.regularize import regularization_terms

    # Tikhonov reg rides the streamed OMG chunks (fused broadcasts); the
    # standalone dense apply needs (Fijab, Fijab)-scale HLO temps at 13k dof
    reg = regularization_terms(cfg)
    return assemble_system(cfg, tables, reg_terms=reg)


def normal_equations_fn(cfg: SFFTConfig):
    """Jittable (mI, mJ) -> (lhs, rhs) for residual certification."""

    def tables(mI, mJ):
        return _normal_equations_impl(cfg, mI, mJ)

    return tables


def _solve_impl(cfg: SFFTConfig, mI: jnp.ndarray, mJ: jnp.ndarray,
                shared=None) -> jnp.ndarray:
    dt = jnp.dtype(cfg.dtype)
    lhs, rhs = _normal_equations_impl(cfg, mI, mJ, shared=shared)
    return solve_system(cfg, lhs, rhs).astype(dt)


def _subtract_impl(
    cfg: SFFTConfig, I: jnp.ndarray, J: jnp.ndarray, solution: jnp.ndarray,
    shared=None,
) -> jnp.ndarray:
    if cfg.fdiff_backend in ("exact", "pexact"):
        # pair-arithmetic paths build their own basis-weighted planes
        return fdiff(cfg, solution, None, None, J, None, I=I, shared=shared)
    # fft32: the difference is computed in f32/c64 anyway — build the basis
    # plane stacks directly in f32.
    dt = jnp.dtype("float32" if cfg.fdiff_backend == "fft32" else cfg.dtype)
    I = I.astype(dt)
    J = J.astype(dt)
    SI, ST, SSc = _plane_stacks(cfg, I, dtype=dt)
    return fdiff(cfg, solution.astype(dt), SI, ST, J, SSc)


def _jit(cfg: SFFTConfig, fn):
    """jit, lifting traced constants to runtime arguments for the exact
    backends: their sliced static tables are tens of MB, which would
    otherwise be embedded in the executable (utils/jitconst.py)."""
    if {"exact", "pexact"} & {cfg.greek_backend, cfg.fdiff_backend}:
        from sfft_jax.utils.jitconst import jit_const_args

        return jit_const_args(fn)
    return jax.jit(fn)


@lru_cache(maxsize=64)
def _jitted_solve(cfg: SFFTConfig):
    return _jit(cfg, partial(_solve_impl, cfg))


@lru_cache(maxsize=64)
def _jitted_subtract(cfg: SFFTConfig):
    return _jit(cfg, partial(_subtract_impl, cfg))


def solve_and_subtract_fn(cfg: SFFTConfig):
    """One fused, jittable solve+subtract step (solve on the masked pair,
    apply to the unmasked pair). For the exact backends the basis-weighted
    pair planes + forward spectra are computed ONCE and passed to both the
    table builder and the difference constructor when the masked and unmasked
    inputs are the same traced arrays (XLA's CSE does not reliably dedupe the
    two pipelines).
    This is the flagship forward step."""
    both_exact = cfg.greek_backend == "exact" and cfg.fdiff_backend == "exact"
    both_pexact = (cfg.greek_backend == "pexact"
                   and cfg.fdiff_backend == "pexact")

    def step(I, J, mI, mJ):
        shared = None
        if both_exact:
            from sfft_jax.core.greek import exact_plane_spectra

            dt = jnp.dtype(cfg.dtype)
            shared = exact_plane_spectra(mI.astype(dt), mJ.astype(dt), cfg)
        elif both_pexact:
            from sfft_jax.core.pexact import pexact_plane_spectra

            dt = jnp.dtype(cfg.dtype)
            shared = pexact_plane_spectra(mI.astype(dt), mJ.astype(dt), cfg)
        sol = _solve_impl(cfg, mI, mJ, shared=shared)
        # trace-time identity: True only when the ENCLOSING traced function
        # passes the same tracer object twice (a 2-arg wrapper calling
        # step(I, J, I, J) — bench, solve_and_subtract_same_fn). Under the
        # generic 4-parameter jit the four inputs are always distinct
        # tracers, so the masked solve and unmasked subtract correctly keep
        # separate spectra there (they genuinely differ in survey use).
        same = (I is mI) and (J is mJ)
        diff = _subtract_impl(
            cfg, I, J, sol,
            shared=shared if ((both_exact or both_pexact) and same) else None)
        return sol, diff

    return step


def solve_and_subtract_same_fn(cfg: SFFTConfig):
    """Fused step for the masked == unmasked special case (2 array inputs):
    passing the same tracers through `step` makes the exact backends share
    ONE plane-spectra pass between solve and difference. Use when the caller solves and applies on the identical pair."""
    step = solve_and_subtract_fn(cfg)

    def step_same(I, J):
        return step(I, J, I, J)

    return step_same


@lru_cache(maxsize=64)
def _jitted_solve_and_subtract_same(cfg: SFFTConfig):
    return _jit(cfg, solve_and_subtract_same_fn(cfg))


@lru_cache(maxsize=64)
def _jitted_solve_and_subtract(cfg: SFFTConfig):
    return _jit(cfg, solve_and_subtract_fn(cfg))


class ElementalSFFT:
    """Reference ElementalSFFTSubtract.ESS equivalent (array-in/array-out)."""

    @staticmethod
    def ESS(
        PixA_I,
        PixA_J,
        cfg: SFFTConfig,
        SFFTSolution: Optional[jnp.ndarray] = None,
        Subtract: bool = False,
    ):
        if PixA_I.shape != (cfg.N0, cfg.N1) or PixA_J.shape != (cfg.N0, cfg.N1):
            raise ValueError(
                f"input images must have shape ({cfg.N0}, {cfg.N1}); "
                f"got {PixA_I.shape} / {PixA_J.shape}"
            )
        solution = SFFTSolution
        if solution is None:
            solution = _jitted_solve(cfg)(jnp.asarray(PixA_I), jnp.asarray(PixA_J))
        diff = None
        if Subtract:
            diff = _jitted_subtract(cfg)(
                jnp.asarray(PixA_I), jnp.asarray(PixA_J), jnp.asarray(solution)
            )
        return solution, diff


def elemental_subtract(PixA_I, PixA_J, cfg, solution=None, subtract=False):
    return ElementalSFFT.ESS(PixA_I, PixA_J, cfg, solution, subtract)


class GeneralSFFT:
    """Reference GeneralSFFTSubtract.GSS equivalent: solve on the masked pair,
    apply to the unmasked pair, optionally propagate a contamination mask by
    convolving it with the fitted kernel (threshold -0.001;
    sfft/sfftcore/SFFTSubtract.py:906-921)."""

    @staticmethod
    def GSS(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg: SFFTConfig, ContamMask_I=None):
        shapes = {
            tuple(PixA_I.shape),
            tuple(PixA_J.shape),
            tuple(PixA_mI.shape),
            tuple(PixA_mJ.shape),
        }
        if len(shapes) > 1:
            raise ValueError("input images must share one shape")

        if PixA_I is PixA_mI and PixA_J is PixA_mJ and ContamMask_I is None:
            # masked == unmasked (same host arrays): one fused program whose
            # exact backends share a single plane-spectra pass between solve
            # and difference (solve_and_subtract_same_fn)
            solution, diff = _jitted_solve_and_subtract_same(cfg)(
                jnp.asarray(PixA_I), jnp.asarray(PixA_J))
            return solution, diff, None

        solution, _ = ElementalSFFT.ESS(PixA_mI, PixA_mJ, cfg, None, Subtract=False)
        _, diff = ElementalSFFT.ESS(PixA_I, PixA_J, cfg, solution, Subtract=True)

        contam_out = None
        if ContamMask_I is not None:
            tsol = jnp.asarray(solution).at[-cfg.Fpq :].set(0.0)
            tI = jnp.asarray(ContamMask_I).astype(jnp.dtype(cfg.dtype))
            tJ = jnp.zeros_like(tI)
            _, tD = ElementalSFFT.ESS(tI, tJ, cfg, tsol, Subtract=True)
            contam_out = tD < -0.001
        return solution, diff, contam_out


def general_subtract(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg, contam_mask_I=None):
    return GeneralSFFT.GSS(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg, contam_mask_I)
