"""Exact-grade (double-float) FFT and windowed correlation via
integer-sliced matmuls (Ozaki-style) + compensated f32 pair arithmetic.

Why this exists: the f64 parity contract (BASELINE.md: difference matches the
reference to 1e-6 RMS) requires the normal-equation correlation tables to
~1e-13 *norm-wise* relative accuracy (measured sensitivity: 1e-13 table noise
-> 3e-7 solution error; 1e-7 -> 0.75). On hardware without a complex128 FFT,
c64 FFT has ~1e-7 rounding. This module reaches ~1e-14 using only f32 and
int8 primitives:

  * numbers ride as PAIRS of f32 planes (hi + lo ~ 48-53 bits);
  * every large contraction (DFT butterflies, partial inverse-DFT windows) is
    decomposed into 6-bit integer slices; slice products are int8 x int8 ->
    int32 `lax.dot_general`s whose accumulation is EXACT, recombined in
    compensated f32 pair arithmetic;
  * DFTs use a two-stage Cooley-Tukey factorization N = R*S so the per-stage
    matmuls are small ((R x R) and (S x S) with twiddles folded into the
    second stage's per-batch static matrices), keeping total slice-matmul
    work ~45 * 2N sqrt(N) MACs per axis instead of 45 * N^2.

Validated: 1D/2D spectra to ~1e-14 norm-wise of exact f64 FFT; windowed
correlation tables to ~3e-14 entrywise (prototype + tests/test_exact_fft.py).

Replaces (for the 'exact' Greek backend) the reference's complex128
HadProd/FFT pipeline (sfft/sfftcore/SFFTSubtract.py:145-168, 224-383) with
an f64-emulating equivalent that holds the full f64 contract for ARBITRARY spatial
bases — polynomial or B-spline with any knot layout (no smoothness or knot-
spacing assumptions, unlike the peel backends in core/peel.py, core/peel_pw.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

NB = 6                  # bits per integer slice
NSL_DATA = 9            # data slices (54 bits)
NSL_STATIC = 8          # static-matrix slices (48 bits). At 7 the
                        # direct-DFT spectrum error (prime lengths, and each
                        # Cooley-Tukey stage) degrades to its 42-bit static
                        # floor 2^-42 = 2.3e-13 (1.8e-13 at N=97 vs the
                        # 1e-13 contract bound; tests/test_exact_fft.py) —
                        # the corr-table metric hides the loss because its
                        # error is data-slice-dominated. Static
                        # depth must match the pair lanes' 48 bits.
KMAX = 8                # keep slice combos with i + j <= KMAX


class SliceProfile(NamedTuple):
    """Per-call override of the slicing depth.

    The module defaults (NSL_DATA/NSL_STATIC/KMAX) are the full contract
    profile: ~2^-48-grade tables relative to the RAW plane scale. The
    peeled engine (core/pexact.py) runs the sliced transforms on the
    smooth-subtracted FLUCTUATION only, whose correlations are the same
    order as the *cancelled* normal-equation entries — so the same absolute
    table accuracy needs fewer slices, and slice-dot work scales ~nsl_d*nsl_w
    (deep contractions) / ~#combos(kmax) (butterfly stages)."""

    nsl_data: int
    nsl_static: int
    kmax: int


def _prof_or_default(prof: Optional["SliceProfile"]) -> "SliceProfile":
    # resolved at call time so accuracy sweeps that rebind the module
    # globals keep working
    if prof is None:
        return SliceProfile(NSL_DATA, NSL_STATIC, KMAX)
    return prof


# ---------------------------------------------------------------------------
# pair (double-float) helpers — all f32 elementwise
# ---------------------------------------------------------------------------


class CPair(NamedTuple):
    """Complex array as four f32 planes (real hi/lo, imag hi/lo); imag parts
    None for a real array. hi + lo carries ~48 bits of significand."""

    rh: jnp.ndarray
    rl: jnp.ndarray
    ih: Optional[jnp.ndarray]
    il: Optional[jnp.ndarray]

    @property
    def is_real(self) -> bool:
        return self.ih is None


def pair_from_f64(x: jnp.ndarray) -> CPair:
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return CPair(hi, lo, None, None)


def pair_to_c128(p: CPair):
    re = p.rh.astype(jnp.float64) + p.rl
    if p.ih is None:
        return re
    return re + 1j * (p.ih.astype(jnp.float64) + p.il)


def _fence(x):
    """Compiler fence for compensated arithmetic: identity on finite floats,
    but opaque to both optimizer levels that break error-free transforms.

    Why not lax.optimization_barrier: XLA removes it before fusion, after
    which (a) the algebraic simplifier's FP rewrites can cancel compensation
    patterns, and (b) XLA:CPU duplicates producer muls into consumer fusions
    where LLVM contracts mul+add into FMA — changing fl(a+b) when an operand
    is a product, which breaks TwoSum's exactness (measured: half-ulp errors,
    2^11 absolute on 2^47 spectra products). copysign(|x|, x) survives to
    codegen (neither XLA algsimp nor LLVM DAGCombine folds it) and its result
    is not an fmul node, so no contraction pattern matches through it.
    Verified: with this fence jitted TwoSum-of-products error is exactly 0."""
    return jnp.copysign(jnp.abs(x), x)


def _two_sum(a, b):
    """Knuth TwoSum in f32: a + b = s + e exactly (fenced, see _fence)."""
    a = _fence(a)
    b = _fence(b)
    s = _fence(a + b)
    v = _fence(s - a)
    e = (a - (s - v)) + (b - v)
    return s, e


def _chain(groups, weights):
    """Compensated sum of f32 tensors with static power-of-2 weights
    (descending). Returns (hi, lo) f32. Exact-integer group values.

    Terms whose weight is <= 2^-24 of the leading one are first summed in
    plain f32 (their own rounding lands below 2^-48 of the total) — a TwoSum
    per term is 6 memory passes over image-sized tensors and dominated the
    FFT stage traffic."""
    w0 = weights[0]
    big = [(g, w) for g, w in zip(groups, weights) if w > w0 * 2.0 ** -24]
    small = [(g, w) for g, w in zip(groups, weights) if w <= w0 * 2.0 ** -24]
    h = big[0][0] * np.float32(big[0][1])
    l = jnp.zeros_like(h)
    for g, w in big[1:]:
        h, e = _two_sum(h, g * np.float32(w))
        l = l + e
    if small:
        tail = small[0][0] * np.float32(small[0][1])
        for g, w in small[1:]:
            tail = tail + g * np.float32(w)
        l = l + tail
    # renormalize (fence: stops (h + l) - h -> l from erasing the low part)
    h2 = _fence(h + l)
    l2 = l - (h2 - h)
    return h2, l2


# ---------------------------------------------------------------------------
# integer slicing
# ---------------------------------------------------------------------------


def _pow2ceil_scalar(m):
    """Traced EXACT power-of-2 > m (elementwise). exp2(ceil(log2(m))) is not
    an option: XLA's f32 exp2 is an approximation and returns non-powers-of-2
    (e.g. 8192.0039), which silently breaks the exact-division invariant the
    integer slicing relies on. Extract the exponent from the f32 bit pattern
    instead: s = 2^(biased_exponent - 126), i.e. the power of two in (m, 2m]."""
    m = jnp.maximum(m.astype(jnp.float32), jnp.float32(1e-30))
    bits = lax.bitcast_convert_type(m, jnp.int32)
    expo = (bits >> 23) & 0xFF
    s_bits = (expo + 1) << 23
    return lax.bitcast_convert_type(s_bits, jnp.float32)


def _slice_pair_real(hi: jnp.ndarray, lo: jnp.ndarray, nsl: int,
                     rowwise: bool = False, int8: bool = True):
    """(hi, lo) f32 -> (slices stacked on axis 0, pow-2 scale).
    value == scale * sum_q slices[q] * 2^{-NB (q+1)}  (+ O(2^-NB*nsl)).

    int8=True casts slices to int8 (for exact int32-accumulated dots on deep
    contractions); int8=False keeps integer-valued f32 slices (for shallow
    contractions whose f32 dot accumulation stays exact below 2^24).

    rowwise=True scales per row (all leading dims, max over the last axis,
    shape (..., 1)): essential when row magnitudes span many orders (e.g.
    cross-spectra, whose DC row dwarfs everything) — a global scale would
    throw away the small rows' significance."""
    if rowwise:
        s = _pow2ceil_scalar(jnp.max(jnp.abs(hi), axis=-1, keepdims=True))
    else:
        s = _pow2ceil_scalar(jnp.max(jnp.abs(hi)))
    # Canonicalize so |lo| <= ulp(hi)/2 (pair lows produced by _chain can
    # reach ~2 ulp; un-canonicalized lows overflowed the post-injection slice
    # past the int8 range and WRAPPED — measured 3e3 absolute table error).
    hi2 = _fence(hi + lo)
    lo = lo - (hi2 - hi)
    hi = hi2
    r0 = hi / s
    inject = 4  # hi fully consumed after ceil(24/NB) = 4 slices
    # the sequential remainder chain's serial dependency makes XLA share one
    # materialization of the fused producer (Hadamard, twiddles) across all
    # slices; a telescoped form without the chain recomputes the producer
    # into each slice's fusion
    out = _seq_slices(r0, lo / s, nsl, inject, int8)
    return jnp.stack(out), s


def _seq_slices(r0, lo_over_s, nsl: int, inject: int, int8: bool):
    """Sequential remainder-chain slicing."""
    r = r0
    out = []
    for q in range(nsl):
        sc = np.float32(2.0 ** (NB * (q + 1)))
        p = jnp.round(r * sc)
        out.append(p.astype(jnp.int8) if int8 else p)
        r = r - p / sc
        if q == inject - 1:
            r = r + lo_over_s
    return out


from collections import OrderedDict

_INTERN: "OrderedDict" = OrderedDict()
_INTERN_BUDGET = 1024 * 1024 * 1024   # host bytes; LRU-evicted beyond this


def _intern(a: np.ndarray) -> np.ndarray:
    """Return ONE canonical ndarray per content. The MLIR lowering caches
    module constants by object identity, so interning the static tables
    collapses what used to be 4-22 duplicated multi-MB hex blobs per module
    (the 4K StableHLO was 121.7 MB of which 119.5 MB was duplicated
    constant text).
    Byte-bounded LRU so a long-lived survey process over many distinct
    (shape, kernel) configs cannot grow host RAM without bound; eviction only
    drops the canonical reference (live traces keep their own)."""
    import hashlib

    a = np.ascontiguousarray(a)
    key = (a.dtype.str, a.shape, hashlib.sha1(a.tobytes()).digest())
    got = _INTERN.get(key)
    if got is None:
        a.setflags(write=False)
        _INTERN[key] = a
        total = sum(int(v.nbytes) for v in _INTERN.values())
        while total > _INTERN_BUDGET and len(_INTERN) > 1:
            _, ev = _INTERN.popitem(last=False)
            total -= int(ev.nbytes)
        return a
    _INTERN.move_to_end(key)
    return got


def _slice_static(M: np.ndarray, nsl: int = None, int8: bool = True):
    """Static real matrix -> (integer slices (nsl, ...), pow2 scale). numpy.
    nsl defaults to the CURRENT module NSL_STATIC (resolved at call time so
    accuracy sweeps that rebind the global actually take effect)."""
    if nsl is None:
        nsl = NSL_STATIC
    mx = np.max(np.abs(M))
    s = float(2.0 ** np.ceil(np.log2(mx))) if mx > 0 else 1.0
    r = (M / s).astype(np.float64)
    out = []
    for q in range(nsl):
        sc = 2.0 ** (NB * (q + 1))
        p = np.round(r * sc)
        assert np.max(np.abs(p)) <= 127
        out.append(p.astype(np.int8) if int8 else p.astype(np.float32))
        r = r - p / sc
    return _intern(np.stack(out)), s


def _group_combos(nsl_d: int, nsl_w: int, kmax: int):
    """combo (i, j) lists per weight group s = i + j."""
    groups = []
    for s_ in range(min(kmax, nsl_d + nsl_w - 2) + 1):
        combos = [(i, s_ - i) for i in range(max(0, s_ - nsl_w + 1),
                                             min(nsl_d - 1, s_) + 1)]
        if combos:
            groups.append((s_, combos))
    return groups


def _pad_cols(M: np.ndarray, mult: int = 64) -> np.ndarray:
    """Zero-pad the LAST axis to a multiple of `mult`: dots with odd narrow
    output dims compile slowly — always present aligned outputs and slice
    the pad off afterwards."""
    m = (-M.shape[-1]) % mult
    if m == 0:
        return M
    pads = [(0, 0)] * M.ndim
    pads[-1] = (0, m)
    return np.pad(M, pads)


def _accum(outs, weights, sc, big: bool):
    """Weighted pair-combine of group sums (int32 or exact-integer f32).
    `big`: int32 values may exceed f32's exact-integer range — split each
    into a 2^12-aligned top plus remainder (both exact in f32) before the
    compensated chain."""
    fo, fw = [], []
    for out, w_ in zip(outs, weights):
        if big and out.dtype == jnp.int32:
            top = (out >> 12) << 12
            fo.append(top.astype(jnp.float32))
            fw.append(w_)
            fo.append((out - top).astype(jnp.float32))
            fw.append(w_)
        else:
            fo.append(out.astype(jnp.float32))
            fw.append(w_)
    h, l = _chain(fo, fw)
    return h * sc, l * sc


def _sliced_dot_multi(dsl, s_d, Wsl_parts, s_w_parts, batch_static: bool,
                      M: int, kmax: Optional[int] = None):
    """Exact product contraction of ONE data slice-set against SEVERAL static
    slice-sets at once (typically a complex matrix's real and imag parts,
    stacked along the output axis so the data slices are read once).

    dsl: (nsl_d, ..., K) int8 data slices; Wsl_parts: list of (nsl_w, [B,]
    K, Mp) int8 static slice-sets, PRE-PADDED to Mp (multiple of 64) with M
    true output columns. Parts may be numpy or device arrays (see
    _static_slices_for). Returns one f32 (hi, lo) pair per part. Products
    accumulate in int32 EXACTLY (|prod| <= 2^12, depths < 2^17).

    Two shapes of the same contraction, chosen by depth:
      * deep K (partial-iDFT stages, K = image axis): one dot per data slice
        against ALL static slices of ALL parts stacked along the output axis
        — avoids giant concat buffers (9x data size) and narrow dots;
      * shallow K (DFT butterfly stages): one dot per weight group with the
        group's slice pairs concatenated along K and the parts stacked along
        the output (output here is data-sized, so slice-stacking it would
        multiply it by nsl_w)."""
    nparts = len(Wsl_parts)
    nsl_d = dsl.shape[0]
    nsl_w = Wsl_parts[0].shape[0]
    K = dsl.shape[-1]
    Mp = Wsl_parts[0].shape[-1]
    groups = _group_combos(nsl_d, nsl_w, KMAX if kmax is None else kmax)

    def scaled(s_d_, s_w_):
        if isinstance(s_w_, jnp.ndarray):
            return s_d_ * s_w_.astype(jnp.float32)
        return s_d_ * np.float32(s_w_)

    if not batch_static and K >= 1024:
        # columns ordered (part p, slice j) -> offset (p*nsl_w + j)*Mp
        Wstack = jnp.concatenate(
            [jnp.asarray(W[j]) for W in Wsl_parts for j in range(nsl_w)],
            axis=-1)
        # data slices beyond the last group (i > kmax) appear in no combo
        ni = min(nsl_d, groups[-1][0] + 1)
        # ONE dot, the slice axis folded into the batch (scanned-dot form):
        # vs nsl_d separate unrolled dots this shrinks the generated dot
        # section ~nsl_d-fold at identical math — int32 accumulation per slice
        per_i = lax.dot_general(
            dsl[:ni], Wstack, (((dsl.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        results = []
        for p, s_w in enumerate(s_w_parts):
            outs, weights = [], []
            for s_, combos in groups:
                acc = None
                for i, j in combos:
                    off = (p * nsl_w + j) * Mp
                    piece = per_i[i][..., off : off + M]
                    acc = piece if acc is None else acc + piece
                outs.append(acc)
                weights.append(2.0 ** (-NB * (s_ + 2)))
            results.append(_accum(outs, weights, scaled(s_d, s_w), big=True))
        return results

    # shallow-K path: parts stacked along the output of each group dot
    group_outs = []
    for s_, combos in groups:
        dcat = jnp.concatenate([dsl[i] for i, _ in combos], axis=-1)
        wcat = jnp.concatenate(
            [jnp.concatenate([jnp.asarray(W[j]) for _, j in combos], axis=-2)
             for W in Wsl_parts], axis=-1)
        if batch_static:
            # data (..., B, Kc), static (B, Kc, nparts*Mp): batch over B
            out = lax.dot_general(
                dcat, wcat,
                (((dcat.ndim - 1,), (1,)), ((dcat.ndim - 2,), (0,))),
                preferred_element_type=jnp.int32,
                precision=lax.Precision.HIGHEST)
            out = jnp.moveaxis(out, 0, -2)
        else:
            out = lax.dot_general(
                dcat, wcat, (((dcat.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
                precision=lax.Precision.HIGHEST)
        group_outs.append(out)
    # exact-int32-in-f32 bound: the LEADING slice reaches 64 (|r| <= 1), all
    # later slices stay <= 33 (remainder <= half ulp of the previous slice),
    # so a combo containing slice 0 can reach 64*33 per product — use that
    # worst case (not 33*33) when deciding whether group sums can exceed
    # f32's exact-integer range.
    big = 64 * 33 * max(len(c) for _, c in groups) * K >= 2 ** 24
    results = []
    for p, s_w in enumerate(s_w_parts):
        outs = [g[..., p * Mp : p * Mp + M] for g in group_outs]
        weights = [2.0 ** (-NB * (s_ + 2)) for s_, _ in groups]
        results.append(_accum(outs, weights, scaled(s_d, s_w), big=big))
    return results


def _static_slices_for(M: np.ndarray, nsl: int = None):
    """Integer slices of a static real matrix, columns pre-padded to a
    multiple of 64. BIG tables (the partial-iDFT phase matrices, >= 128 KB of
    slices) are built ON DEVICE from a compact f32 (hi, lo) pair parent via
    _slice_pair_real: the executable then carries no multi-MB int8 literal
    and no multi-MB int8 argument either — just a small f64-grade parent that is ~nsl x smaller.
    Small tables stay host-built numpy (embedded or lifted, both cheap).

    Returns (slices (nsl, K, Mp) [np or jnp], scale [float or traced])."""
    if nsl is None:
        nsl = NSL_STATIC   # resolved at call time (sweepable global)
    Mp_ = _pad_cols(np.asarray(M, np.float64), 64)
    if Mp_.size * nsl >= 2 ** 17:
        hi = _intern(Mp_.astype(np.float32))
        lo = _intern((Mp_ - Mp_.astype(np.float32)).astype(np.float32))
        return _slice_pair_real(jnp.asarray(hi), jnp.asarray(lo), nsl,
                                rowwise=False, int8=True)
    return _slice_static(Mp_, nsl)


def _sliced_dot(dsl, s_d, Wsl, s_w, batch_static: bool, M: int):
    return _sliced_dot_multi(dsl, s_d, [Wsl], [s_w], batch_static, M)[0]


def _cmatmul_sliced(data: CPair, Wre: np.ndarray, Wim: np.ndarray,
                    batch_static: bool = False,
                    rowwise: bool = False,
                    real_out: bool = False,
                    prof: Optional[SliceProfile] = None) -> CPair:
    """Exact complex matmul: data (..., K) pair  @  static complex W.
    W layouts: (K, M), or (B, K, M) with batch_static=True batching over the
    data's axis -2. Returns pair (..., M) (batched: (..., B, M)).

    real_out=True (complex data x complex W only): compute just the REAL
    part (re = dr.wr - di.wi), skipping the two cross dots — the final
    inverse-DFT stage of a real-valued output needs nothing else."""
    # int8 slices throughout: 4x less slice-buffer traffic than f32 slices
    # and exact int32 accumulation at any depth.
    p = _prof_or_default(prof)
    M = Wre.shape[-1]
    wr_sl, swr = _static_slices_for(Wre, nsl=p.nsl_static)
    dr_sl, sdr = _slice_pair_real(data.rh, data.rl, p.nsl_data, rowwise,
                                  int8=True)
    have_wi = Wim is not None and np.max(np.abs(Wim)) > 0
    if have_wi:
        wi_sl, swi = _static_slices_for(Wim, nsl=p.nsl_static)
        W_parts, s_parts = [wr_sl, wi_sl], [swr, swi]
    else:
        W_parts, s_parts = [wr_sl], [swr]
    if not data.is_real:
        di_sl, sdi = _slice_pair_real(data.ih, data.il, p.nsl_data, rowwise,
                                      int8=True)

    if real_out and not data.is_real and have_wi:
        rr_h, rr_l = _sliced_dot_multi(dr_sl, sdr, [wr_sl], [swr],
                                       batch_static, M, kmax=p.kmax)[0]
        ii_h, ii_l = _sliced_dot_multi(di_sl, sdi, [wi_sl], [swi],
                                       batch_static, M, kmax=p.kmax)[0]
        zr_h, e1 = _two_sum(rr_h, -ii_h)
        return CPair(zr_h, rr_l - ii_l + e1, None, None)

    outs_r = _sliced_dot_multi(dr_sl, sdr, W_parts, s_parts, batch_static, M,
                               kmax=p.kmax)
    rr_h, rr_l = outs_r[0]
    if have_wi:
        ri_h, ri_l = outs_r[1]
    else:
        ri_h = ri_l = jnp.zeros_like(rr_h)
    if not data.is_real:
        outs_i = _sliced_dot_multi(di_sl, sdi, W_parts, s_parts, batch_static,
                                   M, kmax=p.kmax)
        ir_h, ir_l = outs_i[0]
        if have_wi:
            ii_h, ii_l = outs_i[1]
        else:
            ii_h = ii_l = jnp.zeros_like(ir_h)
        # (r + i i)(wr + i wi): re = r wr - i wi ; im = r wi + i wr
        zr_h, e1 = _two_sum(rr_h, -ii_h)
        zr_l = rr_l - ii_l + e1
        zi_h, e2 = _two_sum(ri_h, ir_h)
        zi_l = ri_l + ir_l + e2
        return CPair(zr_h, zr_l, zi_h, zi_l)
    return CPair(rr_h, rr_l, ri_h, ri_l)


# ---------------------------------------------------------------------------
# exact DFT via two-stage Cooley-Tukey with sliced matmuls
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _factor(N: int) -> Tuple[int, int]:
    R = int(np.sqrt(N))
    while R > 1 and N % R:
        R -= 1
    return R, N // R


@lru_cache(maxsize=None)
def _dft_stage_mats(N: int, inverse: bool):
    """Static matrices for the factorized DFT.

    Index algebra (decimation in time over n = a + R*b):
      G[a, d]  = sum_b x[a + R b] e^{-+2 pi i b d / S}
      X[S c+d] = sum_a G[a, d] e^{-+2 pi i a d / N} e^{-+2 pi i a c / R}

    The twiddle e^{+-2 pi i a d / N} is applied as an ELEMENTWISE pair
    product between the two plain (S,S)/(R,R) matmul stages. Folding it into
    a d-batched static matrix is algebraically tidier but far slower to
    compile."""
    R, S = _factor(N)
    sgn = 2j * np.pi * (1 if inverse else -1)
    DS = np.exp(sgn * np.outer(np.arange(S), np.arange(S)) / S)
    DR = np.exp(sgn * np.outer(np.arange(R), np.arange(R)) / R)
    tw = np.exp(sgn * np.outer(np.arange(R), np.arange(S)) / N)     # (a, d)
    return R, S, DS, DR, tw


def _pair_mul_static(v: CPair, W: np.ndarray) -> CPair:
    """Elementwise complex pair product v * W with a static complex factor
    (broadcast over leading dims), accurate to ~2^-48 relative."""
    wr = jnp.asarray(_intern(W.real.astype(np.float32)))
    wr_l = jnp.asarray(_intern(
        (W.real - W.real.astype(np.float32)).astype(np.float32)))
    wi = jnp.asarray(_intern(W.imag.astype(np.float32)))
    wi_l = jnp.asarray(_intern(
        (W.imag - W.imag.astype(np.float32)).astype(np.float32)))
    prr, err = _two_prod(v.rh, wr)
    pii, eii = _two_prod(v.ih, wi)
    pri, eri = _two_prod(v.rh, wi)
    pir, eir = _two_prod(v.ih, wr)
    cr = err - eii + v.rh * wr_l + v.rl * wr - v.ih * wi_l - v.il * wi
    ci = eri + eir + v.rh * wi_l + v.rl * wi + v.ih * wr_l + v.il * wr
    ur, e1 = _two_sum(prr, -pii)
    ui, e2 = _two_sum(pri, pir)
    return CPair(ur, cr + e1, ui, ci + e2)


def _pair_mul_static_rr(v: CPair, W: np.ndarray) -> CPair:
    """REAL pair * static REAL factor (broadcastable), ~2^-48 relative.
    Cheap: fused f32 elementwise."""
    wh = jnp.asarray(_intern(np.asarray(W, np.float64).astype(np.float32)))
    wl = jnp.asarray(_intern(
        (np.asarray(W, np.float64)
         - np.asarray(W, np.float64).astype(np.float32).astype(np.float64))
        .astype(np.float32)))
    p, e = _two_prod(v.rh, jnp.broadcast_to(wh, np.broadcast_shapes(
        v.rh.shape, wh.shape)))
    lo = e + v.rh * wl + v.rl * wh
    return CPair(p, lo, None, None)


def pair_sep_mul(p: CPair, u: np.ndarray, v: np.ndarray) -> CPair:
    """p * u[:, None] * v[None, :] for a real pair p and static 1D factors —
    exact-grade basis-plane weighting without f64 elementwise ops."""
    q = _pair_mul_static_rr(p, u[:, None])
    return _pair_mul_static_rr(q, v[None, :])


def pair_stack(pairs) -> CPair:
    """Stack CPairs along a new leading axis (imag parts must match)."""
    rh = jnp.stack([q.rh for q in pairs])
    rl = jnp.stack([q.rl for q in pairs])
    if pairs[0].ih is None:
        return CPair(rh, rl, None, None)
    return CPair(rh, rl, jnp.stack([q.ih for q in pairs]),
                 jnp.stack([q.il for q in pairs]))


def _pair_mul_static_real_in(v: CPair, W: np.ndarray) -> CPair:
    """Pair product for a REAL v (ih is None) with static complex W."""
    wr = jnp.asarray(_intern(W.real.astype(np.float32)))
    wr_l = jnp.asarray(_intern(
        (W.real - W.real.astype(np.float32)).astype(np.float32)))
    wi = jnp.asarray(_intern(W.imag.astype(np.float32)))
    wi_l = jnp.asarray(_intern(
        (W.imag - W.imag.astype(np.float32)).astype(np.float32)))
    prr, err = _two_prod(v.rh, wr)
    pri, eri = _two_prod(v.rh, wi)
    cr = err + v.rh * wr_l + v.rl * wr
    ci = eri + v.rh * wi_l + v.rl * wi
    return CPair(prr, cr, pri, ci)


def exact_dft_axis(x: CPair, N: int, inverse: bool = False,
                   real_out: bool = False,
                   half_out: bool = False,
                   prof: Optional[SliceProfile] = None) -> CPair:
    """Exact-grade DFT over the LAST axis (length N) of a pair array.

    real_out=True: return only the REAL part of the transform (as a real
    pair) — the cross dots of the final butterfly stage are skipped, saving
    a quarter of the axis work when the result is known to be real (the
    inverse transform of a Hermitian-folded difference spectrum).

    half_out=True: return only bins k <= N//2 (the Hermitian half for real
    input). The second butterfly stage computes X[S c + d] — restricting to
    c <= R//2 covers every needed k, so the stage-2 dots and their pair
    accumulation run at half width instead of computing the full spectrum
    and slicing."""
    R, S, DS, DR, tw = _dft_stage_mats(N, inverse)
    sh = x.rh.shape[:-1]

    def rs(v):
        return None if v is None else v.reshape(sh + (S, R))

    # layout (..., b, a): x[a + R b] == x.reshape(S, R)[b, a]
    data = CPair(rs(x.rh), rs(x.rl), rs(x.ih), rs(x.il))
    if R == 1:
        # prime N: single full DFT matmul over b (depth N)
        DSc = DS[:, : N // 2 + 1] if half_out else DS
        out = _cmatmul_sliced(
            CPair(data.rh[..., 0], data.rl[..., 0],
                  None if data.ih is None else data.ih[..., 0],
                  None if data.il is None else data.il[..., 0]),
            DSc.real.copy(), DSc.imag.copy(), real_out=real_out, prof=prof)
        return out
    # stage 1: G[a, d] = sum_b x[b, a] DS[b, d] — contract b (axis -2).
    # move a before b so the contraction axis is last: (..., a, b)
    def mv(v):
        return None if v is None else jnp.swapaxes(v, -1, -2)

    d1 = CPair(mv(data.rh), mv(data.rl), mv(data.ih), mv(data.il))
    G = _cmatmul_sliced(d1, DS.real, DS.imag, prof=prof)   # (..., a, d)
    # twiddle U[a, d] = G[a, d] * tw[a, d] (elementwise pair product)
    U = _pair_mul_static(G, tw)
    # stage 2: X[S c + d] = sum_a U[a, d] DR[a, c] — contract a
    d2 = CPair(mv(U.rh), mv(U.rl), mv(U.ih), mv(U.il))  # (..., d, a)
    Rc = R // 2 + 1 if half_out else R
    DRc = DR[:, :Rc] if half_out else DR
    V = _cmatmul_sliced(d2, DRc.real.copy(), DRc.imag.copy(),
                        real_out=real_out, prof=prof)  # (..., d, c)
    # X[k] with k = S c + d -> layout (..., c, d)
    Nc = N // 2 + 1 if half_out else N

    def fin(v):
        if v is None:
            return None
        v = jnp.swapaxes(v, -1, -2).reshape(sh + (Rc * S,))
        return v[..., :Nc] if half_out else v

    return CPair(fin(V.rh), fin(V.rl), fin(V.ih), fin(V.il))


def exact_sep_weighted_spectra(head, base: CPair, U: np.ndarray,
                               V: np.ndarray,
                               prof: Optional[SliceProfile] = None) -> CPair:
    """Stacked half spectra of  list(head) + [base * U[k][:, None] *
    V[k][None, :]  for k]  — the separable-weight fast path of
    exact_fft2_pair(half=True).

    head: real CPairs transformed as-is (e.g. the J plane); base: one real
    CPair (the I plane or its fluctuation); U (F, N0) / V (F, N1): static
    f64 row/column weights per output plane (basis-plane factors).

    Two structural savings over transforming F + len(head) full planes:
      * the axis-1 (column) legs run once per DISTINCT V row — a basis
        plane's row weight U[k] depends only on axis 0, so it COMMUTES with
        the axis-1 transform (applied to the transformed rows instead, the
        same ~2^-48 pair product either way). A degree-2 polynomial basis
        dedupes 7 -> 4 legs; a (Fi x Fj) B-spline product basis Fi*Fj -> Fj.
      * both legs ride lax.map bodies compiled once.

    The axis-1 real leg is the most expensive repeated unit of the pair-FFT
    stage, so this dedup is its biggest lever."""
    F = U.shape[0]
    nh = len(head)
    keys = {}
    vsrc = []                       # per plane: deduped axis-1 leg index
    vrows = []
    for k in range(F):
        kb = V[k].tobytes()
        if kb not in keys:
            keys[kb] = len(vrows)
            vrows.append(V[k])
        vsrc.append(keys[kb])
    N0 = base.rh.shape[-2]
    N1 = base.rh.shape[-1]

    planes1 = list(head)
    for vr in vrows:
        if np.all(vr == 1.0):
            planes1.append(base)
        else:
            planes1.append(_pair_mul_static_rr(base, vr[None, :]))
    st1 = pair_stack(planes1)
    T = lax.map(lambda rl_: exact_dft_axis(
        CPair(rl_[0], rl_[1], None, None), N1, half_out=True, prof=prof),
        (st1.rh, st1.rl))                              # (nh+nv, N0, N1h)

    src = np.concatenate([np.arange(nh), nh + np.asarray(vsrc)])
    W = np.concatenate([np.ones((nh, N0)), U], axis=0)
    Wh = W.astype(np.float32)
    Wl = (W - Wh.astype(np.float64)).astype(np.float32)
    args = (T.rh[src], T.rl[src], T.ih[src], T.il[src],
            jnp.asarray(_intern(Wh))[:, :, None],
            jnp.asarray(_intern(Wl))[:, :, None])

    def body(a):
        rh, rl, ih, il, wh, wl = a

        def one(h, l):
            p, e = _two_prod(h, jnp.broadcast_to(wh, h.shape))
            return p, e + h * wl + l * wh

        zrh, zrl = one(rh, rl)
        zih, zil = one(ih, il)

        def mv(v):
            return jnp.swapaxes(v, -1, -2)

        zt = exact_dft_axis(CPair(mv(zrh), mv(zrl), mv(zih), mv(zil)),
                            N0, prof=prof)
        return (mv(zt.rh), mv(zt.rl), mv(zt.ih), mv(zt.il))

    out = lax.map(body, args)
    return CPair(*out)


@lru_cache(maxsize=None)
def _idft_halfin_mats(N: int):
    """Static matrices for the half-input real inverse over the last axis:

        y[n] = Re( sum_{k=0}^{N/2-1} x[k] e^{+2 pi i k n / N} ),   N even.

    Cooley-Tukey over M = N/2 = R*S with k = a + R*b (a < R, b < S; R the
    LARGER factor so the stage-1 contraction depth is the small one):
      stage 1  H[a, m] = sum_b x[a + R b] ES[b, m],  ES[b, m] = e^{2pi i b m / (N/R)}
      stage 2  y[m + (N/R) t] = Re( sum_a (H tw)[a, m] ER[a, t] ),
               tw[a, m] = e^{2pi i a m / N},  ER[a, t] = e^{2pi i a t / R}.

    vs zero-padding the Hermitian half to full width and running the plain
    inverse (the pre-r5 fdiff path): the stage-1 data is HALF the size (half
    the slicing traffic) and the total MAC work drops ~25%."""
    M = N // 2
    r, s_ = _factor(M)
    R = max(r, s_)
    S = M // R
    m_ = N // R                       # stage-1 output width = 2S
    ES = np.exp(2j * np.pi * np.outer(np.arange(S), np.arange(m_)) / m_)
    tw = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(m_)) / N)
    ER = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return R, S, m_, ES, tw, ER


def exact_idft_halfin_real(x: CPair, N: int,
                           prof: Optional[SliceProfile] = None) -> CPair:
    """Real inverse DFT over the last axis from the FOLDED Hermitian half.

    x: pair (..., N//2+1), fold weights already applied (weight-2 interior
    columns, weight-1 DC and Nyquist). Returns the real pair
    y[n] = Re(sum_{k<=N/2} x[k] e^{+2 pi i k n/N}) WITHOUT the 1/N scale.
    N must be even and composite (else callers keep the zero-pad path)."""
    assert N % 2 == 0, "half-input inverse needs even N"
    R, S, m_, ES, tw, ER = _idft_halfin_mats(N)
    sh = x.rh.shape[:-1]
    M = N // 2

    def rs(v):
        # x[a + R b] == x[..., :M].reshape(S, R)[b, a]; contract b (axis -2)
        return None if v is None else jnp.swapaxes(
            v[..., :M].reshape(sh + (S, R)), -1, -2)

    d1 = CPair(rs(x.rh), rs(x.rl), rs(x.ih), rs(x.il))      # (..., a, b)
    H = _cmatmul_sliced(d1, ES.real, ES.imag, prof=prof)    # (..., a, m)
    U = _pair_mul_static(H, tw)

    def mv(v):
        return None if v is None else jnp.swapaxes(v, -1, -2)

    d2 = CPair(mv(U.rh), mv(U.rl), mv(U.ih), mv(U.il))      # (..., m, a)
    Y = _cmatmul_sliced(d2, ER.real, ER.imag, real_out=True,
                        prof=prof)                          # (..., m, t)

    def fin(v):
        return jnp.swapaxes(v, -1, -2).reshape(sh + (N,))   # n = m_ t + m

    yh, yl = fin(Y.rh), fin(Y.rl)
    # Nyquist column: + Re(x[N/2]) * (-1)^n  (sign is exact, mul exact)
    sign = np.ones(N, np.float32)
    sign[1::2] = -1.0
    sj = jnp.asarray(_intern(sign))
    nh, ne = _two_sum(yh, x.rh[..., M, None] * sj)
    nl = yl + x.rl[..., M, None] * sj + ne
    return CPair(nh, nl, None, None)


def exact_fft2_pair(F: jnp.ndarray, plane_chunk: int = 0,
                    half: bool = False,
                    prof: Optional[SliceProfile] = None) -> CPair:
    """Exact-grade full complex 2-D spectrum of a real f64 stack (..., N0, N1).
    Returns pair (..., N0, N1) — or (..., N0, N1//2+1) with half=True, which
    keeps only the Hermitian half over the last axis (valid for REAL input;
    the axis-0 transform then runs on half the columns, and
    exact_corr_window folds the redundancy with weight-2 phases).

    A leading stack axis is processed in chunks through lax.map: the
    transform body is compiled ONCE and peak memory stays bounded by the
    chunk (slicing intermediates are ~40x the plane size in f32).

    F may be an f64 array OR an already-pair-represented real CPair (the
    engine builds basis-weighted planes directly in pair arithmetic)."""
    is_pair = isinstance(F, CPair)
    ref = F.rh if is_pair else F
    N0, N1 = ref.shape[-2], ref.shape[-1]
    if ref.ndim == 3:
        if plane_chunk <= 0:
            # keep per-chunk slicing transients well under 1 GB: the stage
            # group-concats (up to 9x64-wide per group, several live at once)
            # dominate device memory at 4K
            plane_chunk = int(max(1, min(8, 2 ** 24 // (N0 * N1))))
        if ref.shape[0] > plane_chunk:
            npl = ref.shape[0]
            pad = (-npl) % plane_chunk

            def pf(v):
                return jnp.pad(v, ((0, pad), (0, 0), (0, 0))).reshape(
                    -1, plane_chunk, N0, N1)

            if is_pair:
                Fp = CPair(pf(F.rh), pf(F.rl), None, None)
                out = lax.map(
                    lambda f: exact_fft2_pair(CPair(f[0], f[1], None, None),
                                              half=half, prof=prof),
                    (Fp.rh, Fp.rl))
            else:
                out = lax.map(lambda f: exact_fft2_pair(f, half=half,
                                                        prof=prof), pf(F))
            Nc = N1 // 2 + 1 if half else N1
            return CPair(*(None if v is None else
                           v.reshape(-1, N0, Nc)[:npl] for v in out))
    x = F if is_pair else pair_from_f64(F)
    y = exact_dft_axis(x, N1, half_out=half, prof=prof)

    def mv(v):
        return None if v is None else jnp.swapaxes(v, -1, -2)

    yt = CPair(mv(y.rh), mv(y.rl), mv(y.ih), mv(y.il))
    z = exact_dft_axis(yt, N0, prof=prof)
    return CPair(mv(z.rh), mv(z.rl), mv(z.ih), mv(z.il))


# ---------------------------------------------------------------------------
# exact windowed correlation from pair spectra
# ---------------------------------------------------------------------------


def _two_prod(a, b):
    """Dekker TwoProd in f32 (no FMA assumed): a*b = p + e exactly.

    Fences protect p (its rounding defines e) and the Veltkamp split products
    a*C from FMA contraction / simplification; the partial products ah*bh
    etc. are 24-bit-exact in f32 by construction, so contraction of the e-sum
    itself is value-preserving and needs no fence."""
    C = np.float32(4097.0)
    p = _fence(a * b)
    a1 = _fence(a * C)
    b1 = _fence(b * C)
    asub = _fence(a1 - a)
    bsub = _fence(b1 - b)
    ah = a1 - asub
    al = a - ah
    bh = b1 - bsub
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _pair_hadamard_conj(A: CPair, B: CPair) -> CPair:
    """H = A * conj(B) elementwise, pair-accurate (~2^-48)."""
    # real = ar br + ai bi ; imag = ai br - ar bi
    prr, err = _two_prod(A.rh, B.rh)
    pii, eii = _two_prod(A.ih, B.ih)
    pri, eri = _two_prod(A.rh, B.ih)
    pir, eir = _two_prod(A.ih, B.rh)
    # cross lo terms (f32 precision suffices: lo ~ 2^-24 rel)
    cr = err + eii + A.rh * B.rl + A.rl * B.rh + A.ih * B.il + A.il * B.ih
    ci = eir - eri + A.ih * B.rl + A.il * B.rh - A.rh * B.il - A.rl * B.ih
    hr, e1 = _two_sum(prr, pii)
    hi, e2 = _two_sum(pir, -pri)
    return CPair(hr, cr + e1, hi, ci + e2)


@lru_cache(maxsize=None)
def _corr_emats(N0: int, N1: int, wx: int, wy: int, half: bool = False):
    """E1 (N1[h], R1) then E0 (N0, R0) partial-iDFT phase matrices
    (1/(N0*N1) folded into E0). half=True: spectra carry only k1 <= N1//2;
    Hermitian symmetry of real-input cross-spectra is folded as weight-2
    interior columns (the final Re() recovers the conjugate half: the paired
    (-k0,-k1) term of every (k0,k1) bin is its conjugate)."""
    lag0 = np.arange(-wx, wx + 1)
    lag1 = np.arange(-wy, wy + 1)
    n1 = N1 // 2 + 1 if half else N1
    E1 = np.exp(2j * np.pi * np.outer(np.arange(n1), (-lag1) % N1) / N1)
    if half:
        w = np.full(n1, 2.0)
        w[0] = 1.0
        if N1 % 2 == 0:
            w[-1] = 1.0
        E1 = w[:, None] * E1
    E0 = np.exp(2j * np.pi * np.outer(np.arange(N0), (-lag0) % N0) / N0) \
        / (N0 * N1)
    return E0, E1


def exact_corr_window(specA: CPair, specB: CPair, N0: int, N1: int,
                      wx: int, wy: int, pairs: Optional[Tuple] = None,
                      symmetric: bool = False,
                      chunk: Optional[int] = None,
                      prof: Optional[SliceProfile] = None) -> jnp.ndarray:
    """CC(A_a, B_b)[rho, eps] for |rho|<=wx, |eps|<=wy, exact-grade.

    specA/specB: pair spectra stacks (Fa, N0, N1) / (Fb, N0, N1) from
    exact_fft2_pair. Returns (Fa, Fb, 2wx+1, 2wy+1) f64 (with `pairs`
    =(ia, jb): (npairs, R0, R1); symmetric=True computes the upper triangle
    of A x A and mirrors)."""
    Fa = specA.rh.shape[0]
    Fb = specB.rh.shape[0]
    half = specA.rh.shape[-1] != N1
    E0, E1 = _corr_emats(N0, N1, wx, wy, half=half)
    if chunk is None:
        # keep the per-chunk pair-Hadamard + slice transients under ~1 GB
        # (sized on the actual spectra width — half-spectra double the chunk)
        chunk = int(max(1, min(16, 2 ** 25 // (N0 * specA.rh.shape[-1]))))

    if symmetric:
        ia, jb = np.triu_indices(Fa)
    elif pairs is not None:
        ia, jb = pairs
    else:
        ia, jb = [x.ravel() for x in
                  np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij")]
    npairs = len(ia)

    def body(idx_pair):
        iaa, jbb = idx_pair
        A = CPair(specA.rh[iaa], specA.rl[iaa], specA.ih[iaa], specA.il[iaa])
        B = CPair(specB.rh[jbb], specB.rl[jbb], specB.ih[jbb], specB.il[jbb])
        H = _pair_hadamard_conj(A, B)                    # (c, N0, N1)
        Y = _cmatmul_sliced(H, E1.real, E1.imag, rowwise=True,
                            prof=prof)                   # (c, N0, R1)

        def mvt(v):
            return jnp.swapaxes(v, -1, -2)

        Yt = CPair(mvt(Y.rh), mvt(Y.rl), mvt(Y.ih), mvt(Y.il))  # (c, R1, N0)
        Z = _cmatmul_sliced(Yt, E0.real, E0.imag, rowwise=True,
                            prof=prof)                   # (c, R1, R0)
        # CC = Re(sum_k0 Y[k0] E0[k0]) — real part only
        cc = (Z.rh.astype(jnp.float64) + Z.rl)
        return jnp.swapaxes(cc, -1, -2)                  # (c, R0, R1)

    # chunk pairs through lax.map (compile one body)
    pad = (-npairs) % chunk
    ia_p = np.concatenate([ia, np.zeros(pad, ia.dtype)])
    jb_p = np.concatenate([jb, np.zeros(pad, jb.dtype)])
    idx = (jnp.asarray(ia_p).reshape(-1, chunk), jnp.asarray(jb_p).reshape(-1, chunk))
    out = lax.map(body, idx)
    out = out.reshape(-1, 2 * wx + 1, 2 * wy + 1)[:npairs]

    if symmetric:
        full = jnp.zeros((Fa, Fa, 2 * wx + 1, 2 * wy + 1), out.dtype)
        full = full.at[ia, jb].set(out)
        full = full.at[jb, ia].set(out[:, ::-1, ::-1])
        return full
    if pairs is not None:
        return out
    return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)
