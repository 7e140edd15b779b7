"""Normal-equation assembly from correlation tables via static gathers.

Replaces the reference's FillLS_{OMG,GAM,PSI,PHI,THE,DEL} scatter kernels
(sfft/sfftcore/SFFTConfigure.py:197-688) and their SEPARATE-scaling variants
(OMG11/01/10/00, GAM1/0, PSI1/0, THE1/0; sfft/BSplineSFFT.py:1353-1990).

Unifying idea: the delta-function kernel basis makes every basis image either
  shift(I*beta_ij, (a, b)) - I*beta_ij   (non-center offsets, KERNEL basis)
  I*sigma_ij                             (center offset, SCALING basis)
where sigma == beta in ENTANGLED mode. Writing row terms as
{(shift a8, +1) on beta, (id, -1) on beta} for non-center rows and
{(id, +1) on sigma} for center rows (likewise columns), every LHMAT entry is a
signed sum of <= 4 gathers from cross-correlation lag tables of the
(beta-weighted, sigma-weighted) plane stacks:

  LH = c1_r c1_c Pbb(a8-a) + c1_r c0_c Pbb(a8) + c1_r cs_c Pbs(a8)
     + c0_r c1_c Pbb(-a)   + c0_r c0_c Pbb(0)  + c0_r cs_c Pbs(0)
     + cs_r c1_c Psb(-a)   + cs_r c0_c Psb(0)  + cs_r cs_c Pss

with c1 = [offset != center], c0 = -c1, cs = 1 - c1, and Psb the lag-mirror of
Pbs. Fully vectorized static gathers — no scatter, no per-entry control flow.
This one code path reproduces all four reference FillLS case tables in both
ENTANGLED and SEPARATE modes (verified against the dense-design-matrix oracle
in tests).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig
from sfft_jax.core.indices import ab_tables


class GreekTables(NamedTuple):
    """Scaled Pre tables (reference PreOMG etc. values).

    Pbb:  (Fij, Fij, 4w0+1, 4w1+1)  CC(I*beta_a, I*beta_b), lag idx l+2w
    Pbs:  (Fij, Fij, 2w0+1, 2w1+1)  CC(I*beta_a, I*sigma_b) (ENTANGLED: window
                                    of Pbb)
    Pss:  (Fij, Fij)                CC(I*sigma_a, I*sigma_b) at lag 0
    Pgb:  (Fij, Fpq, 2w0+1, 2w1+1)  CC(I*beta_a, T_q)
    Pgs:  (Fij, Fpq)                CC(I*sigma_a, T_q) at lag 0
    Ptb:  (Fij, 2w0+1, 2w1+1)       CC(I*beta_a, J)
    Pts:  (Fij,)                    CC(I*sigma_a, J) at lag 0
    Pphi: (Fpq, Fpq)                CC(T_p, T_q) at lag 0
    Pdel: (Fpq,)                    CC(T_p, J) at lag 0
    """

    Pbb: jnp.ndarray
    Pbs: jnp.ndarray
    Pss: jnp.ndarray
    Pgb: jnp.ndarray
    Pgs: jnp.ndarray
    Ptb: jnp.ndarray
    Pts: jnp.ndarray
    Pphi: jnp.ndarray
    Pdel: jnp.ndarray


@lru_cache(maxsize=64)
def _gather_plan(cfg: SFFTConfig):
    a, b, nz = ab_tables(cfg)
    w0, w1 = cfg.w0, cfg.w1
    R1o = 4 * w1 + 1
    r1 = 2 * w1 + 1

    c1 = nz.astype(np.float64)
    c0 = -c1
    cs = 1.0 - c1

    def oflat(la, lb):
        return ((la + 2 * w0) * R1o + (lb + 2 * w1)).astype(np.int32)

    def gflat(la, lb):
        return ((la + w0) * r1 + (lb + w1)).astype(np.int32)

    z = np.zeros_like(a)
    return dict(
        c1=c1, c0=c0, cs=cs,
        omg_cross=oflat(a[:, None] - a[None, :], b[:, None] - b[None, :]),
        omg_row=oflat(a, b), omg_col=oflat(-a, -b),
        omg_zero=int(oflat(z[:1], z[:1])[0]),
        g_row=gflat(a, b), g_col_neg=gflat(-a, -b),
        g_zero=int(gflat(z[:1], z[:1])[0]),
    )


def _omg_chunk(Fab: int) -> int:
    """Row-offset chunk size for the memory-capped OMG assembly: the largest
    divisor of Fab not exceeding 64."""
    best = 1
    for d in range(1, min(Fab, 64) + 1):
        if Fab % d == 0:
            best = d
    return best


def assemble_system(cfg: SFFTConfig, t: GreekTables,
                    reg_terms=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build (LHMAT, RHb) of the NEQ x NEQ system, identical in value to the
    reference's FillLS output for the active scaling mode.

    Large systems (Fij*Fab >= 8192) build the OMG block in row-offset chunks
    via lax.map, so no NEQ^2-sized intermediate beyond the system itself
    exists (13k-dof B-spline configs).

    reg_terms: optional Kronecker factors [(M (Fij,Fij), R (Fab,Fab))] of
    lambda*REGMAT (regularize.regularization_terms): the Tikhonov kernel
    regularizer is added INSIDE the OMG row construction, where the
    (Fij,Fij,1,1)x(1,1,CH,Fab) broadcasts fuse with the gather arithmetic —
    a standalone dense REGMAT add needs (Fijab,Fijab)-scale HLO temps that
    run out of device memory at 13k dof."""
    import jax

    p = _gather_plan(cfg)
    Fij, Fpq, Fab = cfg.Fij, cfg.Fpq, cfg.Fab
    dt = t.Pbb.dtype
    c1 = jnp.asarray(p["c1"], dt)
    c0 = jnp.asarray(p["c0"], dt)
    cs = jnp.asarray(p["cs"], dt)

    # ---- OMG block -----------------------------------------------------
    Pbbf = t.Pbb.reshape(Fij, Fij, -1)
    Pbsf = t.Pbs.reshape(Fij, Fij, -1)
    Psbf = jnp.swapaxes(Pbsf, 0, 1)
    bb_zero = Pbbf[:, :, p["omg_zero"]][:, :, None, None]
    bs_zero = Pbsf[:, :, p["g_zero"]][:, :, None, None]
    sb_zero = Psbf[:, :, p["g_zero"]][:, :, None, None]
    ss = t.Pss[:, :, None, None]
    k1, k0, ks = c1[None, :], c0[None, :], cs[None, :]
    # column-indexed terms (row-independent)
    bb_col = Pbbf[:, :, p["omg_col"]][:, :, None, :]
    sb_colneg = Psbf[:, :, p["g_row"]][:, :, None, :]
    col_part = (k1 * bb_col + k0 * bb_zero + ks * bs_zero)      # x c0 row
    scl_part = (k1 * sb_colneg + k0 * sb_zero + ks * ss)        # x cs row

    oc = jnp.asarray(p["omg_cross"])
    orow = jnp.asarray(p["omg_row"])
    grow = jnp.asarray(p["g_row"])
    # stream the OMG rows whenever the full-size intermediates would be big:
    # at 13k dof the unchunked (Fij, Fij, Fab, Fab) gather transients are
    # several x 1.4 GB each
    CH = _omg_chunk(Fab) if Fij * Fab >= 8192 else Fab

    reg_jnp = None
    if reg_terms is not None:
        reg_jnp = [(jnp.asarray(M, dt), jnp.asarray(R, dt))
                   for M, R in reg_terms]

    def rows_for(idx):
        """OMG rows for a row-offset subset idx (CH,): (Fij, CH, Fij*Fab)."""
        bb_cross = Pbbf[:, :, oc[idx]]                           # (F,F,CH,Fab)
        bb_row = Pbbf[:, :, orow[idx]][:, :, :, None]
        bs_row = Pbsf[:, :, grow[idx]][:, :, :, None]
        r1 = c1[idx][:, None]
        r0 = c0[idx][:, None]
        rs = cs[idx][:, None]
        blk = (r1 * (k1 * bb_cross + k0 * bb_row + ks * bs_row)
               + r0 * col_part + rs * scl_part)
        if reg_jnp is not None:
            for M, R in reg_jnp:
                blk = blk + M[:, :, None, None] * R[idx][None, None, :, :]
        return jnp.transpose(blk, (0, 2, 1, 3)).reshape(
            Fij, CH, Fij * Fab)

    if CH == Fab:
        omg = rows_for(jnp.arange(Fab)).reshape(Fij * Fab, Fij * Fab)
    else:
        chunks = jnp.asarray(np.arange(Fab).reshape(-1, CH))
        mapped = jax.lax.map(rows_for, chunks)                   # (nc,F,CH,Q)
        omg = jnp.moveaxis(mapped, 0, 1).reshape(Fij * Fab, Fij * Fab)

    # ---- GAM block: rows (i8j8, a8b8), cols pq -------------------------
    Gbf = t.Pgb.reshape(Fij, Fpq, -1)
    gam = (
        c1[None, None, :] * Gbf[:, :, p["g_row"]]
        + c0[None, None, :] * Gbf[:, :, p["g_zero"]][:, :, None]
        + cs[None, None, :] * t.Pgs[:, :, None]
    )
    gam = jnp.transpose(gam, (0, 2, 1)).reshape(Fij * Fab, Fpq)

    # ---- PSI block: rows pq, cols (ij, ab). CC(T, I*beta)[-a] == Pgb(a);
    # CC(T, I*sigma)[0] == Pgs. ------------------------------------------
    psi = (
        c1[None, None, :] * Gbf[:, :, p["g_row"]]
        + c0[None, None, :] * Gbf[:, :, p["g_zero"]][:, :, None]
        + cs[None, None, :] * t.Pgs[:, :, None]
    )
    psi = jnp.transpose(psi, (1, 0, 2)).reshape(Fpq, Fij * Fab)

    # ---- THE / DEL RHS -------------------------------------------------
    Tbf = t.Ptb.reshape(Fij, -1)
    the = (
        c1[None, :] * Tbf[:, p["g_row"]]
        + c0[None, :] * Tbf[:, p["g_zero"]][:, None]
        + cs[None, :] * t.Pts[:, None]
    )
    the = the.reshape(Fij * Fab)

    lhs = jnp.block([[omg, gam.astype(dt)],
                     [psi.astype(dt), t.Pphi.astype(dt)]])
    rhs = jnp.concatenate([the.astype(dt), t.Pdel.astype(dt)])
    return lhs, rhs


def entangled_tables(
    cfg: SFFTConfig,
    Comg: jnp.ndarray,
    Cgam: jnp.ndarray,
    Cthe: jnp.ndarray,
    Cphi: jnp.ndarray,
    Cdel: jnp.ndarray,
) -> GreekTables:
    """Derive the sigma tables from the beta tables when sigma == beta:
    Pbs is the central +-w window of Pbb; lag-0 entries come from the centers."""
    w0, w1 = cfg.w0, cfg.w1
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[:, :, win0, win1]
    Pss = Comg[:, :, 2 * w0, 2 * w1]
    Pgs = Cgam[:, :, w0, w1]
    Pts = Cthe[:, w0, w1]
    return GreekTables(
        Pbb=Comg, Pbs=Pbs, Pss=Pss, Pgb=Cgam, Pgs=Pgs,
        Ptb=Cthe, Pts=Pts, Pphi=Cphi, Pdel=Cdel,
    )
