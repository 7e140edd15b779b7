"""int16 H2D packing (utils/pack.py + parallel/batch.py packed survey path).

The pack halves the host-to-device bytes of f32 for transfer-bound survey
pipelines; it is opt-in. These tests pin (1) the quantization error bound, (2) NaN round-trip
semantics, (3) the packed mesh-batch path agreeing with the unpacked one
inside fast mode's accuracy floor.
"""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
import jax
import jax.numpy as jnp

from sfft_jax.utils.pack import pack_i16, unpack_i16, pack_stack_i16


def test_pack_roundtrip_error_bound(rng):
    a = (rng.normal(size=(130, 97)) *
         np.exp(rng.normal(0, 3, size=(130, 97)))).astype(np.float32)
    p = pack_i16(a, block=64)
    out = np.asarray(jax.jit(
        lambda q, s: unpack_i16(q, s, p.n0, p.block))(p.q, p.scales))
    assert out.shape == a.shape
    # bound: 0.5 * scale per block (scale = blockmax / 32767)
    nb = p.q.shape[0] // p.block
    ap = np.zeros((nb * p.block, a.shape[1]), np.float32)
    ap[: a.shape[0]] = a
    bmax = np.abs(ap.reshape(nb, p.block, -1)).max(axis=(1, 2))
    bound = 0.5 * bmax / 32767.0 + 1e-12
    for b in range(nb):
        lo, hi = b * p.block, min((b + 1) * p.block, a.shape[0])
        blk_err = np.max(np.abs(out[lo:hi] - a[lo:hi]))
        assert blk_err <= bound[b], (b, blk_err, bound[b])


def test_pack_nan_and_zero_blocks(rng):
    a = rng.normal(size=(64, 40)).astype(np.float32)
    a[3, 7] = np.nan
    a[50, :] = np.nan
    z = np.zeros((128, 40), np.float32)  # zero block: scale 1.0, exact
    p = pack_i16(a, block=32)
    out = np.asarray(unpack_i16(jnp.asarray(p.q), jnp.asarray(p.scales),
                                p.n0, p.block))
    assert np.isnan(out[3, 7]) and np.isnan(out[50]).all()
    finite = ~np.isnan(a)
    assert np.isfinite(out[finite]).all()
    pz = pack_i16(z, block=64)
    outz = np.asarray(unpack_i16(jnp.asarray(pz.q), jnp.asarray(pz.scales),
                                 pz.n0, pz.block))
    assert (outz == 0.0).all()


def test_batched_subtract_packed_matches_unpacked(rng):
    """Packed fast-mode survey path over the 8-device mesh == unpacked path
    within the quantization grade (both far inside fast mode's ~7e-3 floor)."""
    from sfft_jax.parallel.batch import (batched_subtract,
                                         batched_subtract_packed,
                                         make_data_mesh)
    from tests.test_engine import make_pair, base_cfg

    cfg = base_cfg(N0=32, N1=32, w=1)
    Is, Js = [], []
    for k in range(8):
        I, J = make_pair(rng, N0=32, N1=32)
        Is.append(I)
        Js.append(J)
    I = np.stack(Is)
    J = np.stack(Js)
    mesh = make_data_mesh(8)
    sols, diffs, _ = batched_subtract(I, J, I, J, cfg, mesh)
    psols, pdiffs, _ = batched_subtract_packed(I, J, I, J, cfg, mesh,
                                               block=32)
    # the ~1.5e-5 input quantization is amplified by the small test
    # system's conditioning to ~3e-3 solution deviation (measured) — inside
    # fast mode's documented ~7e-3 floor; a packed-layout bug would read as
    # O(1) garbage, which is what this guards against
    sref = np.asarray(sols)
    scale = np.max(np.abs(sref))
    assert np.max(np.abs(np.asarray(psols) - sref)) / scale < 1e-2
    dref = np.asarray(diffs)
    rms = np.sqrt(np.mean((np.asarray(pdiffs) - dref) ** 2))
    assert rms < 1e-2 * np.max(np.abs(dref))


def test_prefetch_packs_fast_configs_only():
    """Scheduler prefetch with pack=True (PACK_H2D='auto') ships FAST-mode
    planes as int16 (+ sentinel NaNs) and leaves contract-grade configs
    unpacked; the default ships every plane exactly."""
    import dataclasses

    import numpy as np

    from sfft_jax.config import BasisSpec, SFFTConfig
    from sfft_jax.parallel.scheduler import (_pack_eligible,
                                             _prefetch_pair_planes)

    base = SFFTConfig(N0=96, N1=96, w0=2, w1=2,
                      kernel_basis=BasisSpec("polynomial", 2),
                      bg_basis=BasisSpec("polynomial", 2),
                      greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")
    assert _pack_eligible(base)
    for gb, fb, sv in [("exact", "exact", "exact"),
                       ("pexact", "pexact", "exact"),
                       ("peeled", "fft32", "exact")]:
        assert not _pack_eligible(dataclasses.replace(
            base, greek_backend=gb, fdiff_backend=fb, solver=sv))
    assert not _pack_eligible(None)

    rng = np.random.default_rng(3)
    I = rng.normal(100.0, 10.0, (96, 96))
    I[5, 7] = np.nan
    prep = {"cfg": base, "PixA_I": I.copy(), "PixA_J": I + 1.0,
            "PixA_mI": np.nan_to_num(I), "PixA_mJ": np.nan_to_num(I) + 1.0,
            "ContamMask_I": None}
    exact = _prefetch_pair_planes(dict(prep))
    np.testing.assert_array_equal(np.asarray(exact["PixA_I"]), I)
    out = _prefetch_pair_planes(prep, pack=True)
    got = np.asarray(out["PixA_I"])
    assert np.isnan(got[5, 7])                      # sentinel round trip
    m = np.isfinite(I)
    # quantization bound: 0.5 * blockmax / 32767
    tol = 0.5 * np.nanmax(np.abs(I)) / 32767 * 1.01
    assert np.max(np.abs(got[m] - I[m])) <= tol


def test_mesh_batched_packed_dispatch_matches_unpacked():
    """run_mesh_batched PACK_H2D='auto' packs fast-grade groups; results
    agree with the unpacked dispatch inside fast's accuracy floor."""
    import numpy as np

    from sfft_jax.config import BasisSpec, SFFTConfig
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.scheduler import STATUS_OK, run_mesh_batched

    cfg = SFFTConfig(N0=64, N1=64, w0=1, w1=1,
                     kernel_basis=BasisSpec("polynomial", 1),
                     bg_basis=BasisSpec("polynomial", 1),
                     greek_backend="peeled", fdiff_backend="fft32",
                     solver="refined")
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(8):
        I = 100.0 + rng.normal(0, 3.0, (64, 64))
        J = 1.05 * I + 2.0 + rng.normal(0, 1.0, (64, 64))
        pairs.append((I, J))

    def prep_fn(tid):
        I, J = pairs[tid]
        return {"cfg": cfg, "I": I, "J": J}

    def group_inputs(prep):
        return (prep["cfg"], prep["I"], prep["J"], prep["I"], prep["J"],
                True)

    def subtract_fn(tid, prep, precomputed=None):
        assert precomputed is not None
        _sol, diff = precomputed
        return float(np.sqrt(np.mean(np.asarray(diff) ** 2)))

    mesh = make_data_mesh(8)
    outs = {}
    for mode in ("auto", "off"):
        status, products = run_mesh_batched(
            8, prep_fn, subtract_fn, group_inputs,
            NUM_THREADS_4PREPROC=2, VERBOSE_LEVEL=0, mesh=mesh,
            PACK_H2D=mode)
        assert all(s == STATUS_OK for s in status.values()), status
        outs[mode] = np.array([products[t]["result"] for t in range(8)])
    # quantization moves fast-mode RMS by far less than fast's own floor
    assert np.max(np.abs(outs["auto"] - outs["off"])) < 1e-3
