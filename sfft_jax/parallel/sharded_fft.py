"""Multi-device sharded 2-D FFT over a device mesh.

The reference is single-node with zero inter-GPU communication; for frames
larger than one card SURVEY.md (§5) identifies sharded 2-D FFTs as the
scaling path. Standard pencil decomposition via shard_map:

  rows sharded over the mesh -> local FFT along columns (unsharded axis)
  -> all-to-all transpose (NVLink) -> local FFT along the other axis
  -> all-to-all back (optional, to return to the input sharding)

This keeps each card's FFT fully local and rides the interconnect only for
the transposes, which is how distributed FFTs are done on any mesh fabric.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _all_to_all_transpose(block: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(rows_local, cols_full) -> (rows_full, cols_local) on each device.

    block is the local shard (N0/d, N1). Split axis 1 into d chunks, exchange
    chunk i with device i, concatenate received chunks along axis 0.
    """
    d = jax.lax.psum(1, axis_name)
    n0l, n1 = block.shape
    # (d, n0l, n1/d)
    parts = block.reshape(n0l, d, n1 // d).transpose(1, 0, 2)
    exch = jax.lax.all_to_all(parts, axis_name, split_axis=0, concat_axis=0,
                              tiled=False)
    # exch: (d, n0l, n1/d) where exch[k] is the k-th row-chunk of our column
    return exch.reshape(d * n0l, n1 // d)


def sharded_fft2(
    x: jnp.ndarray, mesh: Mesh, axis_name: str = "data"
) -> jnp.ndarray:
    """2-D FFT of a (N0, N1) array sharded over mesh axis 0.

    Returns the full transform with the same row sharding. Requires N0 and N1
    divisible by the mesh size. complex64/complex128 per platform support.
    """
    d = mesh.devices.size

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis_name, None), out_specs=P(axis_name, None),
    )
    def _fft(local):  # local: (N0/d, N1)
        f1 = jnp.fft.fft(local, axis=1)
        t = _all_to_all_transpose(f1, axis_name)      # (N0, N1/d)
        f2 = jnp.fft.fft(t, axis=0)
        # transpose back to row sharding: (N0/d, N1)
        return _all_to_all_transpose(f2.T, axis_name).T

    return _fft(x)


def sharded_exact_fft2_pair(
    F: jnp.ndarray, mesh: Mesh, axis_name: str = "data",
    half: bool = False, prof=None,
):
    """Hand-scheduled pencil decomposition of the EXACT pair-FFT
    (core/exact_fft.exact_fft2_pair) over a device mesh — the exact
    engine's dominant stage, scheduled explicitly instead of left to XLA sharding propagation.

    F: (N0, N1) real f64, rows sharded over `axis_name`. Each stage's sliced
    butterfly matmuls run fully local (the 1-D transforms are independent
    per row); only the two transposes ride the interconnect, as four-lane
    (rh, rl, ih, il) all_to_all exchanges. half=True keeps the Hermitian
    k1-half; its N1//2+1 columns are zero-padded up to a mesh multiple for
    the exchange and trimmed after (zero columns transform to zero columns).

    Returns the CPair spectrum with the same row sharding. Requires N0 and
    the (padded) column count divisible by the mesh size.
    """
    from sfft_jax.core.exact_fft import CPair, exact_dft_axis, pair_from_f64

    d = mesh.devices.size
    N0, N1 = F.shape
    N1c = N1 // 2 + 1 if half else N1
    pad_c = (-N1c) % d
    N1p = N1c + pad_c
    assert N0 % d == 0, f"N0={N0} not divisible by mesh size {d}"

    def _a2a_t(lanes, n_rows_l, n_cols):
        # lanes: (4, rows_local, cols_full) -> (4, cols_full/d * ... ) i.e.
        # each device ends with (4, rows_full, cols_local)
        parts = lanes.reshape(4, n_rows_l, d, n_cols // d)
        parts = jnp.transpose(parts, (2, 0, 1, 3))        # (d, 4, rl, c/d)
        exch = jax.lax.all_to_all(parts, axis_name, split_axis=0,
                                  concat_axis=0, tiled=False)
        return jnp.transpose(exch, (1, 0, 2, 3)).reshape(
            4, d * n_rows_l, n_cols // d)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=P(axis_name, None),
             out_specs=P(None, axis_name, None))
    def _fft(local):                                       # (N0/d, N1)
        n0l = local.shape[0]
        x = pair_from_f64(local)
        y = exact_dft_axis(x, N1, half_out=half, prof=prof)  # (n0l, N1c)
        lanes = jnp.stack([jnp.pad(v, ((0, 0), (0, pad_c)))
                           for v in (y.rh, y.rl, y.ih, y.il)])
        t = _a2a_t(lanes, n0l, N1p)                        # (4, N0, N1p/d)
        # axis-0 transform: move N0 last (transform axis), local per column
        yt = CPair(*(jnp.swapaxes(t[k], 0, 1) for k in range(4)))
        z = exact_dft_axis(yt, N0, prof=prof)              # (N1p/d, N0)
        lanes2 = jnp.stack([z.rh, z.rl, z.ih, z.il])       # (4, N1p/d, N0)
        # transpose back to row sharding
        back = _a2a_t(lanes2, N1p // d, N0)                # (4, N1p, N0/d)
        return jnp.stack([jnp.swapaxes(back[k], 0, 1)
                          for k in range(4)])              # (4, N0/d, N1p)

    out = _fft(F)
    return CPair(out[0, :, :N1c], out[1, :, :N1c],
                 out[2, :, :N1c], out[3, :, :N1c])


def sharded_subtract_step(cfg, mesh: Mesh, axis_name: str = "data"):
    """Experimental: single huge-pair solve with row-sharded inputs.

    The Greek/moment matmuls and FFT batches partition cleanly over image
    rows; the tiny normal system is solved replicated. Currently exposed as a
    sharding-annotated jit (XLA inserts the collectives); a hand-scheduled
    shard_map pipeline is future work.
    """
    from sfft_jax.core.engine import solve_and_subtract_fn

    step = solve_and_subtract_fn(cfg)
    sharded = NamedSharding(mesh, P(axis_name, None))

    @jax.jit
    def run(I, J, mI, mJ):
        I, J, mI, mJ = (jax.lax.with_sharding_constraint(a, sharded)
                        for a in (I, J, mI, mJ))
        return step(I, J, mI, mJ)

    return run
