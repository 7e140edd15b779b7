"""Unit tests for utils/jitconst.ConstArgsJit — the const-lifting jit used by
the exact contract engine (traced numpy tables become runtime arguments so
the executable stays small on slow-executable-ship runtimes)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfft_jax.utils.jitconst import jit_const_args, _DEVICE_CONSTS_BUDGET


TBL = np.arange(48.0, dtype=np.float64).reshape(6, 8)
CTBL = (np.arange(12.0) + 1j * np.arange(12.0)[::-1]).reshape(3, 4)


def test_matches_plain_jit_and_lifts_consts():
    def fn(x):
        return x @ jnp.asarray(TBL).T

    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 8)))
    np.testing.assert_allclose(np.asarray(jit_const_args(fn)(x)),
                               np.asarray(jax.jit(fn)(x)), rtol=0, atol=0)


def test_output_pytree_preserved():
    """eval_jaxpr returns flat leaves; the wrapper must restore the wrapped
    function's container structure (dict / nested tuple / single array)."""
    def fn_dict(x):
        return {"sol": x * jnp.asarray(TBL), "diff": (x + 1.0, x - 1.0)}

    x = jnp.asarray(np.ones((6, 8)))
    out = jit_const_args(fn_dict)(x)
    assert isinstance(out, dict) and set(out) == {"sol", "diff"}
    assert isinstance(out["diff"], tuple) and len(out["diff"]) == 2
    np.testing.assert_allclose(np.asarray(out["sol"]), TBL)

    def fn_single(x):
        return (x.sum(),)   # 1-element tuple must stay a tuple

    out1 = jit_const_args(fn_single)(x)
    assert isinstance(out1, tuple) and len(out1) == 1

    def fn_bare(x):
        return x.sum()      # bare array stays bare

    out2 = jit_const_args(fn_bare)(x)
    assert not isinstance(out2, tuple)
    assert float(out2) == float(np.sum(np.ones((6, 8))))


def test_complex_consts_ride_as_real_planes():
    def fn(x):
        return jnp.real(x @ jnp.asarray(CTBL)), jnp.imag(x @ jnp.asarray(CTBL))

    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 3)))
    re, im = jit_const_args(fn)(x)
    ref = np.asarray(x) @ CTBL
    np.testing.assert_allclose(np.asarray(re), ref.real, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(im), ref.imag, rtol=1e-12)


def test_device_const_cache_shared_across_instances():
    """Two ConstArgsJit instances tracing the same table must reuse ONE
    device buffer (process-level content cache), not upload duplicates."""
    import sfft_jax.utils.jitconst as jc

    big = np.random.default_rng(2).normal(size=(64, 64))

    def fa(x):
        return x + jnp.asarray(big)

    def fb(x):
        return x * 2.0 + jnp.asarray(big)

    x = jnp.asarray(np.zeros((64, 64)))
    a = jit_const_args(fa)
    b = jit_const_args(fb)
    np.testing.assert_allclose(np.asarray(a(x)), big)
    # match by content digest — the process-level cache legitimately holds
    # other tests' tables, so count only `big`'s entry
    import hashlib

    dig = hashlib.sha1(np.ascontiguousarray(big).tobytes()).digest()
    entries_a = [k for k in jc._DEVICE_CONSTS if k[3] == dig]
    assert len(entries_a) == 1
    buf_a = jc._DEVICE_CONSTS[entries_a[0]]
    np.testing.assert_allclose(np.asarray(b(x)), big)
    entries_b = [k for k in jc._DEVICE_CONSTS if k[3] == dig]
    assert len(entries_b) == 1                      # still ONE entry...
    assert jc._DEVICE_CONSTS[entries_b[0]] is buf_a  # ...the SAME buffer
    assert _DEVICE_CONSTS_BUDGET > 0


def test_signature_cache_no_retrace():
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        return x + jnp.asarray(TBL)

    f = jit_const_args(fn)
    x = jnp.asarray(np.zeros((6, 8)))
    f(x)
    f(x + 1.0)
    assert calls["n"] == 1  # one trace per (shape, dtype) signature
    f(jnp.asarray(np.zeros((6, 8), np.float32)))
    assert calls["n"] == 2


def test_pytree_args_signature():
    """Args may be pytrees whose leaves have mixed shapes (a CPair stack, a
    list of planes) — the signature probe must flatten, not np.asarray the
    container (that raised on inhomogeneous lists, e.g. a NamedTuple of
    mixed-shape arrays)."""
    calls = {"n": 0}

    def fn(tree):
        calls["n"] += 1
        a, (b, c) = tree
        return a.sum() + b.sum() + c.sum()

    f = jit_const_args(fn)
    tree = (np.ones((3, 4)), (np.ones((5,)), np.ones((2, 2, 2))))
    assert float(f(tree)) == 12.0 + 5.0 + 8.0
    f((np.zeros((3, 4)), (np.zeros((5,)), np.zeros((2, 2, 2)))))
    assert calls["n"] == 1      # same signature -> no retrace
    # different structure -> distinct cache entry, not a collision
    f2 = jit_const_args(fn)
    assert float(f2([np.ones((3, 4)), [np.ones((5,)), np.ones((2, 2, 2))]])) \
        == 25.0


def test_numpy_args_accepted_without_eager_transfer():
    """Host numpy args are legal; the signature probe must not round-trip
    them through jnp.asarray (metadata only)."""
    def fn(x):
        return x * jnp.asarray(TBL)

    f = jit_const_args(fn)
    out = f(np.full((6, 8), 2.0))
    np.testing.assert_allclose(np.asarray(out), 2.0 * TBL)
