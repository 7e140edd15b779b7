"""Survey-mode batching: many image pairs across a device mesh.

The reference's multi-task scheduler (MultiEasySparsePacket.py:391-948) pins one
Python thread per CUDA device and hand-rolls a work queue. Equivalent here:
stack homogeneous (same config) pairs on a leading axis and shard the fused
solve+subtract over a 1-D 'data' mesh axis — XLA handles placement and any cross-device reductions; no threads, no locks, no
status dict for the homogeneous path. (The heterogeneous/failure-handling
scheduler lives in sfft_jax/parallel/scheduler.py.)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sfft_jax.config import SFFTConfig
from sfft_jax.core.engine import solve_and_subtract_fn


def make_data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("data",))


@lru_cache(maxsize=32)
def _batched_fn(cfg: SFFTConfig, mesh: Mesh):
    step = solve_and_subtract_fn(cfg)
    vstep = jax.vmap(step)

    sharded = NamedSharding(mesh, P("data"))

    @jax.jit
    def run(I, J, mI, mJ):
        I, J, mI, mJ = (jax.lax.with_sharding_constraint(x, sharded) for x in (I, J, mI, mJ))
        sols, diffs = vstep(I, J, mI, mJ)
        # per-pair QA summary, sharded like the batch (each pair's RMS lives
        # on that pair's device; callers fetch only their addressable shards)
        rms = jnp.sqrt(jnp.mean(diffs.astype(jnp.float32) ** 2, axis=(1, 2)))
        return sols, diffs, rms

    return run


def batched_subtract(
    I_stack, J_stack, mI_stack, mJ_stack, cfg: SFFTConfig, mesh: Optional[Mesh] = None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solve+subtract a stack of pairs, sharded over the mesh 'data' axis.

    Batch size must be a multiple of the mesh size (pad with repeats upstream
    if needed). Returns (solutions, diffs, per-pair diff RMS).
    """
    if mesh is None:
        mesh = make_data_mesh()
    fn = _batched_fn(cfg, mesh)
    return fn(
        jnp.asarray(I_stack), jnp.asarray(J_stack),
        jnp.asarray(mI_stack), jnp.asarray(mJ_stack),
    )


@lru_cache(maxsize=32)
def _batched_packed_fn(cfg: SFFTConfig, mesh: Mesh, n0: int, block: int):
    from sfft_jax.utils.pack import unpack_i16

    step = solve_and_subtract_fn(cfg)

    def one(qI, sI, qJ, sJ, qmI, smI, qmJ, smJ):
        I, J, mI, mJ = (unpack_i16(q, s, n0, block)
                        for q, s in ((qI, sI), (qJ, sJ),
                                     (qmI, smI), (qmJ, smJ)))
        return step(I, J, mI, mJ)

    vstep = jax.vmap(one)
    sharded = NamedSharding(mesh, P("data"))

    @jax.jit
    def run(*packed):
        packed = tuple(jax.lax.with_sharding_constraint(x, sharded)
                       for x in packed)
        sols, diffs = vstep(*packed)
        rms = jnp.sqrt(jnp.mean(diffs.astype(jnp.float32) ** 2, axis=(1, 2)))
        return sols, diffs, rms

    return run


def batched_subtract_packed(
    I_stack, J_stack, mI_stack, mJ_stack, cfg: SFFTConfig,
    mesh: Optional[Mesh] = None, block: int = 64
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FAST-mode survey variant of batched_subtract that ships the four
    input stacks as int16 + per-row-block f32 scales — half the H2D bytes
    of f32 (utils/pack.py) — and dequantizes inside the sharded jit. Quantization
    error ~1.5e-5 of the block max sits two orders below fast mode's own
    accuracy floor; do NOT use with contract configs (their 1e-6-grade
    parity would absorb the quantization error)."""
    from sfft_jax.utils.pack import pack_stack_i16

    if mesh is None:
        mesh = make_data_mesh()
    packed = []
    n0 = np.asarray(I_stack).shape[1]
    for stack in (I_stack, J_stack, mI_stack, mJ_stack):
        q, s, n0, block = pack_stack_i16(np.asarray(stack), block)
        packed.extend((jnp.asarray(q), jnp.asarray(s)))
    fn = _batched_packed_fn(cfg, mesh, n0, block)
    return fn(*packed)
