"""jit with closure constants lifted to runtime arguments.

Why: the exact engines (core/exact_fft.py, core/pexact.py) build large
static tables (sliced-int8 DFT stage matrices, partial-iDFT phase matrices)
as numpy constants inside the traced function, so they would be EMBEDDED in
the XLA executable — tens of MB of literals for one 4K transform, carried by
every compile and every compile-cache entry. Lifting every traced constant
to a runtime argument keeps the executable pure code and uploads the tables
once per process.

Mechanism: `jax.make_jaxpr` splits the function into (jaxpr, consts); the
consts are deduped by content, device_put once, and the jaxpr is re-evaluated
under jit with the consts passed as leading runtime arguments — XLA sees them
as parameters, not literals. The jit is compiled with AUTO input layouts and
the consts are pre-placed in the compiler-chosen layouts, so XLA does not
re-lay-out the tables at every call. Results are cached per (shape, dtype)
signature exactly like jit's own trace cache.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

try:  # jax >= 0.4.x moved eval_jaxpr around; keep both routes
    from jax.core import eval_jaxpr as _eval_jaxpr
except ImportError:  # pragma: no cover
    from jax._src.core import eval_jaxpr as _eval_jaxpr


# process-level device-resident const cache: the solve and subtract jits of
# one config share most of their static tables byte-for-byte, so a
# per-instance cache would upload and hold a duplicate copy on device.
# Byte-bounded LRU — eviction only drops the cache's reference; compiled
# executables keep their own refs to the consts they were built with.
_DEVICE_CONSTS: "OrderedDict[tuple, Any]" = None  # set below
_DEVICE_CONSTS_BUDGET = 512 * 1024 * 1024


def _dedupe_device_put(consts):
    """device_put each const once per distinct content (process-wide)."""
    global _DEVICE_CONSTS
    if _DEVICE_CONSTS is None:
        from collections import OrderedDict as _OD

        _DEVICE_CONSTS = _OD()
    cache = _DEVICE_CONSTS
    backend = jax.default_backend()
    out = []
    for c in consts:
        a = np.asarray(c)
        key = (backend, a.dtype.str, a.shape,
               hashlib.sha1(a.tobytes()).digest())
        got = cache.get(key)
        if got is None:
            got = jax.device_put(c)
            cache[key] = got
            total = sum(int(v.nbytes) for v in cache.values())
            while total > _DEVICE_CONSTS_BUDGET and len(cache) > 1:
                _, ev = cache.popitem(last=False)
                total -= int(ev.nbytes)
        else:
            cache.move_to_end(key)
        out.append(got)
    return out


class _Executable:
    """Compiled program + pre-laid-out constants; call with the user args."""

    def __init__(self, compiled, consts):
        self._compiled = compiled
        self._consts = consts

    def memory_analysis(self):
        return self._compiled.memory_analysis()

    def __call__(self, *args):
        return self._compiled(self._consts, *args)


class ConstArgsJit:
    """Callable wrapping `fn` so traced constants become runtime arguments."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._cache: Dict[Any, _Executable] = {}

    def _sig(self, args):
        # shape/dtype only — never jnp.asarray here (it would eagerly
        # device-transfer full-size host inputs just to read metadata).
        # Flatten first: args may be pytrees (lists/dicts of arrays).
        leaves, treedef = jax.tree_util.tree_flatten(args)
        out = []
        for a in leaves:
            shape = getattr(a, "shape", None)
            dtype = getattr(a, "dtype", None)
            if shape is None or dtype is None:
                a = np.asarray(a)
                shape, dtype = a.shape, a.dtype
            out.append((tuple(shape), str(dtype)))
        return (treedef, tuple(out))

    def _build(self, args) -> _Executable:
        closed, out_shape = jax.make_jaxpr(
            self._fn, return_shape=True)(*args)
        out_tree = jax.tree_util.tree_structure(out_shape)
        # Complex consts ride as real/imag planes and are recombined with
        # lax.complex inside the program (real runtime arguments only).
        specs = []
        reals = []
        for c in closed.consts:
            a = np.asarray(c)
            if np.iscomplexobj(a):
                specs.append((True, len(reals)))
                reals.append(np.ascontiguousarray(a.real))
                reals.append(np.ascontiguousarray(a.imag))
            else:
                specs.append((False, len(reals)))
                reals.append(a)
        consts = _dedupe_device_put(reals)
        jaxpr = closed.jaxpr

        def run(consts_, *args_):
            cs = [jax.lax.complex(consts_[i], consts_[i + 1]) if cplx
                  else consts_[i] for cplx, i in specs]
            # jaxpr invars are the FLAT leaves of the traced args (pytree
            # containers are flattened by make_jaxpr)
            out = _eval_jaxpr(jaxpr, cs, *jax.tree_util.tree_leaves(args_))
            # restore the wrapped function's output pytree (dict/NamedTuple/
            # nested) — eval_jaxpr returns the flat leaves
            return jax.tree_util.tree_unflatten(out_tree, out)

        # default input layouts; the int8 tables are derived on device
        # (exact_fft._slice_static_dev)
        compiled = jax.jit(run).lower(consts, *args).compile()
        return _Executable(compiled, consts)

    def _entry(self, args) -> _Executable:
        key = self._sig(args)
        if key not in self._cache:
            self._cache[key] = self._build(args)
        return self._cache[key]

    def lower(self, *args):
        return _Lowered(self, args)

    def __call__(self, *args):
        return self._entry(args)(*args)


class _Lowered:
    """Minimal .lower()/.compile() shim matching jit's AOT timing protocol
    (the expensive build happens in compile(), like jit)."""

    def __init__(self, owner: ConstArgsJit, args):
        self._owner = owner
        self._args = args

    def compile(self) -> _Executable:
        return self._owner._entry(self._args)


def jit_const_args(fn: Callable) -> ConstArgsJit:
    """Drop-in jit replacement that passes traced constants as runtime args
    in compiler-chosen layouts. Use for programs whose traced bodies embed
    large numpy tables (the exact contract engine); plain `jax.jit` ships
    those tables inside the executable at every process start."""
    return ConstArgsJit(fn)
