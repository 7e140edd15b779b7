"""Dense solve of the SFFT normal equations.

Reference: stripe removal + LU (sfft/sfftcore/SFFTConfigure.py:690-732,
sfft/sfftcore/SFFTSubtract.py:732-757). The ConstPhotRatio "forbidden stripes"
(the kernel-sum dof of every non-constant spatial term) are removed by a static
gather and the solution re-extended by a static scatter — both indices are
numpy constants per config.

Solver backends:
  'lu'    jnp.linalg.solve (LAPACK on the CPU, cuSOLVER on the GPU) — the
          default
  'cho'   Cholesky — the system is a Gram matrix (symmetric positive definite
          in exact arithmetic), so this is valid and faster
  'exact' equilibrated blocked Cholesky + f64-residual refinement
  'refined' equilibrated f32 factor + f64-residual refinement (fast mode)
  'transformed' Legendre congruence + f32 factor + refinement, with a
          certified fallback to 'exact' (polynomial ENTANGLED f64 configs)
  'host'  jax.pure_callback to numpy LAPACK
  'blocked_cho'  on-device blocked Cholesky built from f64 matmuls
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sfft_jax.config import SFFTConfig
from sfft_jax.core.indices import stripe_indices


def _host_solve(lhs: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Opt-in solver='host': LAPACK f64 LU via pure_callback. Exact, but the
    system round-trips to the host per call."""
    def _np_solve(args):
        a, b = args
        return np.linalg.solve(np.asarray(a), np.asarray(b)).astype(a.dtype)

    return jax.pure_callback(
        _np_solve,
        jax.ShapeDtypeStruct(rhs.shape, rhs.dtype),
        (lhs, rhs),
        vmap_method="sequential",
    )


def _blocked_cholesky(A: jnp.ndarray, nb: int = 256,
                      precision=None) -> jnp.ndarray:
    """Lower Cholesky factor via right-looking blocked algorithm.

    Panel factorization and triangular solves stay small (nb x nb); the
    trailing update is one matmul per block column. precision=HIGHEST keeps
    every contraction at full f64 and takes the library panel factorization.
    """
    n = A.shape[0]
    nblk = -(-n // nb)
    npad = nblk * nb
    Ap = jnp.zeros((npad, npad), A.dtype).at[:n, :n].set(A)
    # keep padded diagonal nonsingular
    Ap = Ap.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    L = jnp.zeros_like(Ap)

    def chol_small(M):
        # unblocked Cholesky of an nb x nb block via fori over columns
        def body(j, Lc):
            d = jnp.sqrt(M2[j, j] - jnp.dot(Lc[j, :], Lc[j, :],
                                            precision=precision))
            col = (M2[:, j] - jnp.dot(Lc, Lc[j, :], precision=precision)) / d
            mask = jnp.arange(M.shape[0]) > j
            Lc = Lc.at[:, j].set(jnp.where(mask, col, 0.0))
            Lc = Lc.at[j, j].set(d)
            return Lc

        M2 = M
        return jax.lax.fori_loop(0, M.shape[0], body, jnp.zeros_like(M))

    def tri_solve_lower(Ld, B):
        # solve Ld @ X^T = B^T i.e. X @ Ld^T = B, row block of L
        return jax.scipy.linalg.solve_triangular(Ld, B.T, lower=True).T

    Acur = Ap
    for k in range(nblk):
        s = k * nb
        diag = Acur[s : s + nb, s : s + nb]
        if precision is not None:
            # library panel factorization: the nb x nb diagonal blocks of the
            # equilibrated system are locally well-conditioned, and the
            # refinement in _exact_solve absorbs the panel rounding
            Lkk = jnp.linalg.cholesky(diag)
        else:
            Lkk = chol_small(diag)
        below = Acur[s + nb :, s : s + nb]
        L = L.at[s : s + nb, s : s + nb].set(Lkk)
        if below.shape[0]:
            Lbk = tri_solve_lower(Lkk, below)
            L = L.at[s + nb :, s : s + nb].set(Lbk)
            upd = jnp.dot(Lbk, Lbk.T, precision=precision)
            Acur = Acur.at[s + nb :, s + nb :].add(-upd)
    return L[:n, :n]


def _diag_block_inverses(L: jnp.ndarray, nb: int = 256) -> jnp.ndarray:
    """Explicit inverses of the nb x nb diagonal blocks of lower-triangular L
    via ONE batched triangular solve against I (shape (nblk, nb, nb)), so
    that every panel solve of _blocked_trisolve_inv is a matvec. Padding
    blocks carry an identity diagonal, so the padded inverse's top-left
    corner is the true block inverse."""
    n = L.shape[0]
    nblk = -(-n // nb)
    npad = nblk * nb
    Lp = jnp.zeros((npad, npad), L.dtype).at[:n, :n].set(L)
    Lp = Lp.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    blocks = jnp.stack([Lp[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb]
                        for k in range(nblk)])
    eye = jnp.eye(nb, dtype=L.dtype)
    return jax.vmap(
        lambda M: jax.scipy.linalg.solve_triangular(M, eye, lower=True)
    )(blocks)


def _blocked_trisolve_inv(L: jnp.ndarray, Linv: jnp.ndarray, b: jnp.ndarray,
                          lower: bool, nb: int = 256) -> jnp.ndarray:
    """Blocked triangular substitution using precomputed diagonal-block
    inverses (_diag_block_inverses): HIGHEST-precision off-diagonal updates
    + matvec panel application. lower=False solves L.T x = b with the SAME
    L/Linv."""
    n = L.shape[0]
    hp = jax.lax.Precision.HIGHEST
    nblk = -(-n // nb)
    x = jnp.zeros_like(b)
    order = range(nblk) if lower else range(nblk - 1, -1, -1)
    for k in order:
        s, e = k * nb, min((k + 1) * nb, n)
        rhs = b[s:e]
        if lower and s > 0:
            rhs = rhs - jnp.dot(L[s:e, :s], x[:s], precision=hp)
        if not lower and e < n:
            # (L.T)[s:e, e:] = L[e:, s:e].T
            rhs = rhs - jnp.dot(x[e:], L[e:, s:e], precision=hp)
        inv = Linv[k][: e - s, : e - s]
        xk = jnp.dot(inv if lower else inv.T, rhs, precision=hp)
        x = x.at[s:e].set(xk)
    return x


def _exact_solve(A: jnp.ndarray, b: jnp.ndarray, iters: int = 2) -> jnp.ndarray:
    """Jacobi equilibration + blocked Cholesky with HIGHEST-precision f64
    contractions + f64-residual refinement. The iteration matrix has
    spectral radius ~cond * eps64 (~1e-7 even at cond 3e8), so two
    refinement steps reach the f64 floor."""
    d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A)) + jnp.finfo(A.dtype).tiny)
    As = A * d[:, None] * d[None, :]
    bs = b * d
    hp = jax.lax.Precision.HIGHEST
    L = _blocked_cholesky(As, precision=hp)
    Dinv = _diag_block_inverses(L)

    def solve_tri(r):
        y = _blocked_trisolve_inv(L, Dinv, r, lower=True)
        return _blocked_trisolve_inv(L, Dinv, y, lower=False)

    x = solve_tri(bs)
    bnorm = jnp.linalg.norm(bs)

    def body(state):
        k, x, _ = state
        r = bs - jnp.dot(As, x, precision=hp)
        return k + 1, x + solve_tri(r), jnp.linalg.norm(r)

    def cond(state):
        k, _, rn = state
        return jnp.logical_and(k < iters, rn > 1e-15 * bnorm)

    state = (jnp.int32(0), x, bnorm)
    _, x, _ = jax.lax.while_loop(cond, body, state)
    return x * d


def _refined_solve_f64(A: jnp.ndarray, b: jnp.ndarray,
                       iters: int = 12) -> jnp.ndarray:
    """Solve for LARGE (NEQ >= 8k) regularized systems: f32 Cholesky factor
    + f64-residual refinement to the f64 floor.

    Valid because the Tikhonov-regularized big B-spline systems are far
    better conditioned than the raw polynomial ones: on the NIRCam
    13,226-dof system cond(equilibrated) ~ 1.1e7, so cond*eps32 ~ 0.65 < 1
    and each refinement step contracts the error. The residual matvecs run
    at HIGHEST precision (~n^2 work); the n^3 factorization stays f32. The
    while_loop stops at the residual floor.
    Reference bar: full-f64 LU (sfft/BSplineSFFT.py:3702-3787).

    Validity domain: the equilibrated system must be numerically positive
    definite IN f32 — cond_eq alone does not decide this; the spectrum shape
    does. On breakdown the factor is NaN and the returned solution is
    all-NaN — loudly visible, never silently wrong. solve_system takes this
    route only with Tikhonov regularization ON; raising regularize_lambda is
    the documented recovery."""
    d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A)) + jnp.finfo(A.dtype).tiny)
    bs = b * d
    hp = jax.lax.Precision.HIGHEST
    As = A * d[:, None] * d[None, :]
    L32 = jnp.linalg.cholesky(As.astype(jnp.float32))

    def f32_solve(r):
        y = jax.scipy.linalg.solve_triangular(
            L32, r.astype(jnp.float32), lower=True)
        return jax.scipy.linalg.solve_triangular(
            L32.T, y, lower=False).astype(b.dtype)

    x = f32_solve(bs)
    bnorm = jnp.linalg.norm(bs)

    def body(state):
        k, x, _ = state
        r = bs - jnp.dot(As, x, precision=hp)
        return k + 1, x + f32_solve(r), jnp.linalg.norm(r)

    def cond(state):
        k, _, rn = state
        return jnp.logical_and(k < iters, rn > 1e-15 * bnorm)

    _, x, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), x, bnorm))
    return x * d


def _legendre_congruence(degree: int) -> np.ndarray:
    """Static change of basis C for the triangular 2-D monomial terms
    {x^i y^j : i+j <= degree} (enumeration of indices.ref_basis_exponents)
    into tensor products of SHIFTED Legendre polynomials on [0,1].

    column ij of C holds the monomial coefficients of the Legendre term, so
    for spatial-basis values U (npix, Fij): U_legendre = U @ C. Shifted
    Legendre polynomials have INTEGER coefficients (P~0=1, P~1=2t-1,
    P~2=6t^2-6t+1, P~3=20t^3-30t^2+12t-1), so C is an exact integer matrix
    and the congruence T' A T is computed backward-stably in f64.

    Why: the monomial spatial terms are nearly collinear over the image
    domain — measured on the real 512^2 bench system they contribute a
    factor ~600x to cond(equilibrated) (3.4e8 raw -> 5.6e5 after this
    congruence). In the Legendre basis the
    normal system is well-enough conditioned that an f32 Cholesky factor +
    exact-f64-residual refinement converges to the f64 floor (cond*eps32
    ~0.03 << 1), replacing the exact-f64 blocked factorization's long
    sequential dispatch chain with a handful of library ops."""
    P1 = {
        0: [1],
        1: [-1, 2],
        2: [1, -6, 6],
        3: [-1, 12, -30, 20],
    }
    terms = [(i, j) for i in range(degree + 1) for j in range(degree + 1 - i)]
    F = len(terms)
    C = np.zeros((F, F))
    for col, (p, q) in enumerate(terms):
        cp, cq = P1[p], P1[q]
        for row, (r, s) in enumerate(terms):
            if r < len(cp) and s < len(cq):
                C[row, col] = cp[r] * cq[s]
    return C


def _transformed_solve(cfg: SFFTConfig, lhs: jnp.ndarray, rhs: jnp.ndarray,
                       iters: int = 10) -> jnp.ndarray:
    """Contract-grade solve of the FULL (untweaked) polynomial ENTANGLED
    system via a static Legendre congruence + f32-Cholesky refinement, with a
    certified fallback to the unconditional exact solver.

    Pipeline (all structured ops — reshapes, (Fij x Fij) einsums, library
    f32 factorizations; no O(NEQ) sequential dispatch chains):
      1. y-space change of variables x = S z. S mixes the spatial index of
         every kernel dof through the integer Legendre matrix C
         (_legendre_congruence) and the background dofs through C_bkg. The
         ConstPhotRatio constraint (x_{ij,center}=0 for ij>=1, reference
         "forbidden stripes", sfft/sfftcore/SFFTSubtract.py:525-532) is kept
         EXACTLY: because C z|_center must equal (t,0,...,0), the center-ab
         column block of S degenerates to the single passthrough column
         e_{(0,center)}, and the ij>=1 center columns are zero — their rows/
         cols of S'AS vanish identically and are diagonal-pinned to 1.
      2. A~ = S'AS, b~ = S'b in f64 (HIGHEST): backward-stable since C is a
         small integer matrix — forward effect <= cond(A~_eq) * depth*eps64
         ~1e-8, inside the f64 band of the original solve.
      3. Jacobi equilibration, f32 Cholesky + explicit f32 L^-1 (two library
         ops), exact-f64-residual refinement to the f64 floor (measured on
         the real 512^2 system: 2 refinements reach 2.9e-8 max-rel vs the
         original-basis LAPACK solution — identical to the exact solver's
         conditioning floor cond*eps64).
      4. Certificate: if the final exact residual hasn't converged
         (||r|| > 1e-12 ||b~||, or NaN — e.g. images whose kernel-shift
         collinearity pushes cond(A~_eq)*eps32 past 1 so the f32-factor
         iteration stalls), lax.cond into _exact_solve on the SAME
         transformed system — the unconditional sliced-f64 route. The
         contract therefore never depends on the conditioning win.
    Returns the NEQ solution in the ORIGINAL basis (removed dofs exactly 0).
    """
    from sfft_jax.core.indices import kernel_sum_dof_index

    Fij, Fab, Fijab, Fpq = cfg.Fij, cfg.Fab, cfg.Fijab, cfg.Fpq
    c = cfg.center_ab
    hp = jax.lax.Precision.HIGHEST
    C = _legendre_congruence(cfg.kernel_basis.degree)
    if Fpq > 1 and cfg.bg_basis.kind == "polynomial":
        Cb = _legendre_congruence(cfg.bg_basis.degree)
    else:
        Cb = np.eye(max(Fpq, 1))
    removed = (kernel_sum_dof_index(cfg)[1:].astype(np.int32)
               if cfg.const_phot_ratio else np.zeros((0,), np.int32))
    Cj = jnp.asarray(C, lhs.dtype)
    Cbj = jnp.asarray(Cb, lhs.dtype)

    def S_cols(M):
        # M (r, NEQ) -> M @ S
        r = M.shape[0]
        K = M[:, :Fijab].reshape(r, Fij, Fab)
        K2 = jnp.einsum("ria,ij->rja", K, Cj, precision=hp)
        if removed.size:
            K2 = K2.at[:, 1:, c].set(0.0)
            K2 = K2.at[:, 0, c].set(K[:, 0, c])
        parts = [K2.reshape(r, Fijab)]
        if Fpq:
            parts.append(jnp.dot(M[:, Fijab:], Cbj, precision=hp))
        return jnp.concatenate(parts, axis=1)

    def S_vec(z):
        # x = S z (back to the original basis)
        Zk = z[:Fijab].reshape(Fij, Fab)
        X = jnp.einsum("ja,ij->ia", Zk, Cj, precision=hp)
        if removed.size:
            X = X.at[1:, c].set(0.0)
            X = X.at[0, c].set(Zk[0, c])
        parts = [X.reshape(Fijab)]
        if Fpq:
            parts.append(jnp.dot(Cbj, z[Fijab:], precision=hp))
        return jnp.concatenate(parts)

    At = S_cols(S_cols(lhs).T)
    bt = S_cols(rhs[None, :])[0]
    if removed.size:
        At = At.at[removed, removed].set(1.0)
        bt = bt.at[removed].set(0.0)  # exact zeros already; keep explicit

    d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(At)) + jnp.finfo(At.dtype).tiny)
    As = At * d[:, None] * d[None, :]
    bs = bt * d
    L32 = jnp.linalg.cholesky(As.astype(jnp.float32))
    Li32 = jax.scipy.linalg.solve_triangular(
        L32, jnp.eye(L32.shape[0], dtype=jnp.float32), lower=True)

    def f32_solve(r):
        # precision=HIGHEST: a DEFAULT f32 dot may run in TF32 on the GPU
        y = jnp.dot(Li32, r.astype(jnp.float32), precision=hp)
        return jnp.dot(Li32.T, y, precision=hp).astype(bt.dtype)

    x = f32_solve(bs)
    bnorm = jnp.linalg.norm(bs)

    def body(state):
        k, x, _ = state
        r = bs - jnp.dot(As, x, precision=hp)
        return k + 1, x + f32_solve(r), jnp.linalg.norm(r)

    def cond_fn(state):
        k, _, rn = state
        return jnp.logical_and(k < iters, rn > 1e-15 * bnorm)

    _, x, _ = jax.lax.while_loop(cond_fn, body, (jnp.int32(0), x, bnorm))
    rn = jnp.linalg.norm(bs - jnp.dot(As, x, precision=hp))
    ok = rn <= 1e-12 * bnorm  # False on NaN -> fallback

    y = jax.lax.cond(ok, lambda _: x * d,
                     lambda _: _exact_solve(At, bt), None)
    return S_vec(y)


def _refined_solve(A: jnp.ndarray, b: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Equilibrated float32 LU + float64-residual iterative refinement.

    The fast-mode solver: the factorization runs in f32 and the residuals
    in f64. Jacobi equilibration tames the wildly different column scales of the SFFT system (polynomial
    coordinate powers), then each refinement step recovers ~7 digits until the
    f64 residual floor. Converges when cond(D A D) * eps32 << 1."""
    d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A)) + jnp.finfo(A.dtype).tiny)
    As = A * d[:, None] * d[None, :]
    bs = b * d
    A32 = As.astype(jnp.float32)
    if A.dtype == jnp.float32:
        As = A32  # f32-assembled system: residuals can't beat f32 anyway
    if A.shape[0] >= 8192:
        # the system is a (regularized) Gram matrix, so Cholesky is valid
        # and takes half the factorization work of LU at this size
        L32 = jnp.linalg.cholesky(A32)

        def f32_solve(r):
            y = jax.scipy.linalg.solve_triangular(L32, r.astype(jnp.float32),
                                                  lower=True)
            return jax.scipy.linalg.solve_triangular(
                L32.T, y, lower=False).astype(b.dtype)
    else:
        lu, piv = jax.scipy.linalg.lu_factor(A32)

        def f32_solve(r):
            return jax.scipy.linalg.lu_solve(
                (lu, piv), r.astype(jnp.float32)).astype(b.dtype)

    # Fast-mode solver: its end-to-end accuracy is limited by the
    # mixed-precision TABLES well before the solver floor (bench fast-mode
    # parity is identical under plain refinement, 8-step PCG and 100-step
    # PCG — all stall at cond*eps32 > 1 anyway), so take the cheapest route.
    # The f64-contract path is solver='exact' (_exact_solve below).
    x = f32_solve(bs)
    for _ in range(iters):
        r = bs - As @ x
        x = x + f32_solve(r)
    return x * d


def _contig_segments(idx: np.ndarray):
    """Split a sorted index array into contiguous [start, stop) segments."""
    segs = []
    start = prev = int(idx[0])
    for v in idx[1:]:
        v = int(v)
        if v == prev + 1:
            prev = v
            continue
        segs.append((start, prev + 1))
        start = prev = v
    segs.append((start, prev + 1))
    return segs


def _select_rows_cols(M: jnp.ndarray, idx: np.ndarray) -> jnp.ndarray:
    """M[ix_(idx, idx)] via contiguous slice concatenation.

    The tweak removes only a handful of dofs, so idx is a few contiguous runs;
    slicing+concat lowers to bulk copies instead of a 1.7e8-element fancy
    gather."""
    segs = _contig_segments(np.asarray(idx))
    rows = jnp.concatenate([M[a:b, :] for a, b in segs], axis=0)
    return jnp.concatenate([rows[:, a:b] for a, b in segs], axis=1)


def _tweak_plan(cfg: SFFTConfig):
    """Static tweak indices per scaling mode (reference TweakLS/Restore_Solution,
    sfft/BSplineSFFT.py:2170-2338).

    Returns (pres_idx, aggregate, ij00):
      pres_idx: LS indices kept in the tweaked system (None = no tweak)
      aggregate: True for the B-spline SEPARATE-CONSTANT case, where the key
        center dof becomes the SUM over all Fij center dofs (the B-spline basis
        has no constant member, but is a partition of unity, so constant
        scaling = equal coefficients aggregated into one dof).
    """
    from sfft_jax.core.indices import kernel_sum_dof_index

    ij00 = kernel_sum_dof_index(cfg)
    mode = cfg.scaling_mode
    if mode == "ENTANGLED":
        if not cfg.const_phot_ratio:
            return None, False, ij00
        pres = stripe_indices(cfg)
        return (None if len(pres) == cfg.NEQ else pres), False, ij00
    if mode == "SEPARATE-CONSTANT":
        pres = np.setdiff1d(np.arange(cfg.NEQ), ij00[1:]).astype(np.int32)
        return pres, cfg.kernel_basis.kind == "bspline", ij00
    # SEPARATE-VARYING
    if cfg.ScaFij == cfg.Fij:
        return None, False, ij00
    pres = np.setdiff1d(np.arange(cfg.NEQ), ij00[cfg.ScaFij :]).astype(np.int32)
    return pres, False, ij00


def reduced_system(cfg: SFFTConfig, lhs: jnp.ndarray, rhs: jnp.ndarray):
    """(A, b): the system the solver factors — the normal equations after
    the scaling-mode tweak (removed dofs dropped; for aggregated B-spline
    scaling, the key center dof carries the summed rows/cols)."""
    pres, aggregate, ij00 = _tweak_plan(cfg)
    if pres is None:
        return lhs, rhs
    A = _select_rows_cols(lhs, pres)
    b = rhs[pres]
    if aggregate:
        key = int(ij00[0])  # pres_idx[key] == key (indices below unchanged)
        rowsum = jnp.sum(lhs[np.ix_(ij00, pres)], axis=0)
        colsum = jnp.sum(lhs[np.ix_(pres, ij00)], axis=1)
        allsum = jnp.sum(lhs[np.ix_(ij00, ij00)])
        A = A.at[key, :].set(rowsum)
        A = A.at[:, key].set(colsum)
        A = A.at[key, key].set(allsum)
        b = b.at[key].set(jnp.sum(rhs[ij00]))
    return A, b


def backward_error(cfg: SFFTConfig, lhs: jnp.ndarray, rhs: jnp.ndarray,
                   sol: jnp.ndarray) -> jnp.ndarray:
    """Normwise backward error ||A x - b|| / (||A|| ||x|| + ||b||), infinity
    norm, of an NEQ-length solution on the reduced system (reduced_system)
    after Jacobi equilibration A -> D A D, x -> x / D, b -> D b with
    D = diag(A)^-1/2. A backward-stable solver keeps it near n * eps64
    whatever the system's conditioning. Without the equilibration the norms
    are set by the largest polynomial terms alone, and a solution perturbed
    by 1e-9 relative still scores ~1e-13."""
    A, b = reduced_system(cfg, lhs, rhs)
    pres = _tweak_plan(cfg)[0]
    x = sol if pres is None else sol[pres]
    d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A)) + jnp.finfo(A.dtype).tiny)
    As = A * d[:, None] * d[None, :]
    xs = x / d
    bs = b * d
    r = jnp.dot(As, xs, precision=jax.lax.Precision.HIGHEST) - bs
    norm_a = jnp.max(jnp.sum(jnp.abs(As), axis=1))
    return jnp.max(jnp.abs(r)) / (norm_a * jnp.max(jnp.abs(xs))
                                  + jnp.max(jnp.abs(bs)))


def solve_system(
    cfg: SFFTConfig, lhs: jnp.ndarray, rhs: jnp.ndarray
) -> jnp.ndarray:
    """Solve, honoring the scaling-mode system tweak. Returns the NEQ-length
    solution with removed dofs re-inserted (zeros, or the shared constant for
    aggregated B-spline scaling)."""
    if cfg.solver == "transformed":
        if not (lhs.dtype == jnp.float64
                and cfg.scaling_mode == "ENTANGLED"
                and cfg.kernel_basis.kind == "polynomial"):
            raise ValueError("solver='transformed' requires an f64 "
                             "polynomial ENTANGLED config")
        # the tweak (stripe removal) is carried exactly inside the transform
        return _transformed_solve(cfg, lhs, rhs)

    pres, aggregate, ij00 = _tweak_plan(cfg)
    A, b = reduced_system(cfg, lhs, rhs)

    if cfg.solver == "lu":
        # Jacobi equilibration first: the column scales span the polynomial
        # coordinate powers (cond ~1e15 raw, ~3e9 equilibrated at 1024^2),
        # and a raw LU lands at an implementation-dependent point of that
        # band — cuSOLVER and LAPACK differences reached 1.1e-6 RMS in the
        # 1024^2 difference image, past the 1e-6 parity contract
        d = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A)) + jnp.finfo(A.dtype).tiny)
        x = d * jnp.linalg.solve(A * d[:, None] * d[None, :], b * d)
    elif cfg.solver == "cho":
        c, low = jax.scipy.linalg.cho_factor(A, lower=True)
        x = jax.scipy.linalg.cho_solve((c, low), b)
    elif cfg.solver == "host":
        x = _host_solve(A, b)
    elif cfg.solver == "refined":
        x = _refined_solve(A, b)
    elif cfg.solver == "exact":
        if A.dtype == jnp.float32:
            # f32-assembled system: residuals cannot beat f32 anyway
            x = _refined_solve(A, b)
        elif A.shape[0] >= 8192 and cfg.regularize_lambda > 0 and cfg.reg_xy:
            # large regularized f64 systems (13k-dof NIRCam): f32 factor +
            # f64-residual refinement reaches the f64 floor (see docstring).
            # Tikhonov regularization keeps cond(equilibrated) ~1e7 so the
            # iteration converges (cond*eps32 < 1); an unregularized giant
            # system takes the unconditional route below instead.
            x = _refined_solve_f64(A, b)
        else:
            x = _exact_solve(A, b)
    elif cfg.solver == "blocked_cho":
        L = _blocked_cholesky(A)
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    else:
        raise ValueError(f"unknown solver {cfg.solver!r}")

    if pres is None:
        return x
    sol = jnp.zeros((cfg.NEQ,), x.dtype).at[pres].set(x)
    if aggregate:
        sol = sol.at[ij00[1:]].set(x[int(ij00[0])])
    return sol
