"""Lossy-but-bounded int16 H2D packing for FAST-mode survey throughput.

Why this exists: where host-to-device transfer bounds the end-to-end survey
pipeline, the only lever left is shipping fewer bytes per pixel. Whether
any GPU deployment is transfer-bound has not been measured; the pack stays
opt-in (scheduler PACK_H2D='auto') until a measurement shows it pays.

int16 with one float32 scale per row block halves the bytes of f32. Quantization
error is <= 0.5 * blockmax / 32767 ~ 1.53e-5 of the block's max — below
fast mode's own accuracy floor (its c64-FFT tables), so the pack is
invisible in fast-mode output. It is OPT-IN and must never be used
on the contract path, whose 1e-6-grade parity it would destroy.

NaN handling: NaNs (and any other non-finite pixel — an inf would otherwise
make its block's scale inf and silently zero the whole 64-row block) are
packed as -32768 (a value quantization never produces: quantized magnitudes
are <= 32767) and restored as NaN on unpack, so masked-image NaN semantics
survive the round trip exactly.

Reference context: the reference ships full f32/f64 over PCIe and never
needed this (sfft/EasySparsePacket.py feeds cupy arrays directly).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

_NAN_SENTINEL = -32768


class PackedI16(NamedTuple):
    """Host-side pack product. q is (nblocks*block, N1) int16 (row-padded),
    scales is (nblocks, 1) float32; n0 is the true row count."""

    q: np.ndarray
    scales: np.ndarray
    n0: int
    block: int


def pack_i16(a: np.ndarray, block: int = 64) -> PackedI16:
    """Quantize a 2-D float array to int16 with one f32 scale per `block`
    rows (host side, one vectorized pass). |err| <= 0.5 * scale, where
    scale = max|block| / 32767. Zero blocks get scale 1.0 (exact zeros)."""
    a = np.asarray(a)
    n0, n1 = a.shape
    nb = -(-n0 // block)
    npad = nb * block
    ap = np.zeros((npad, n1), np.float32)
    ap[:n0] = a
    blocks = ap.reshape(nb, block, n1)
    # non-finite (NaN OR +-inf) pixels all ride the sentinel: one inf pixel
    # would otherwise set its block scale to inf and quantize the whole
    # block to 0 (unpack then yields 0*inf = NaN everywhere in the block)
    nanmask = ~np.isfinite(blocks)
    absb = np.abs(np.where(nanmask, 0.0, blocks))
    bmax = absb.max(axis=(1, 2))
    scales = np.where(bmax > 0, bmax / np.float32(32767.0), 1.0).astype(
        np.float32)[:, None]
    q = np.rint(np.where(nanmask, 0.0, blocks)
                / scales[:, :, None]).astype(np.int16)
    if nanmask.any():
        q[nanmask] = _NAN_SENTINEL
    return PackedI16(q.reshape(npad, n1), scales, n0, block)


def unpack_i16(q, scales, n0: int, block: int, dtype=None):
    """Dequantize on device, inside jit: (nblocks*block, N1) int16 + per-
    block scales -> (n0, N1) float. dtype defaults to float64 (the engine's
    input dtype). NaN sentinels are restored."""
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float64
    npad, n1 = q.shape
    nb = npad // block
    qb = q.reshape(nb, block, n1)
    out = qb.astype(jnp.float32) * scales[:, :, None]
    out = jnp.where(qb == _NAN_SENTINEL, jnp.nan, out)
    return out.reshape(npad, n1)[:n0].astype(dtype)


def pack_stack_i16(stack: np.ndarray, block: int = 64
                   ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pack a (B, N0, N1) host stack: returns (q (B, npad, N1) int16,
    scales (B, nblocks, 1) f32, n0, block). vmap(unpack) friendly."""
    packs = [pack_i16(stack[b], block) for b in range(stack.shape[0])]
    q = np.stack([p.q for p in packs])
    s = np.stack([p.scales for p in packs])
    return q, s, packs[0].n0, block
