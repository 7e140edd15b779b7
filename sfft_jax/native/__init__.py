"""Native C++ kernels with transparent build-on-first-use and numpy fallbacks.

The reference ships two Cython extensions (houghLine/_hough_transform,
houghLine/_ccomp). Here a single C++ extension provides both hot loops; if the
toolchain is unavailable the pure-numpy fallbacks keep everything working
(slower, same results).
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

import numpy as np

_native = None
_tried = False


def _build_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "_build")


def _try_load():
    global _native, _tried
    if _tried:
        return _native
    _tried = True
    bdir = _build_dir()
    if bdir not in sys.path:
        sys.path.insert(0, bdir)
    try:
        import _native as mod  # type: ignore

        _native = mod
        return _native
    except ImportError:
        pass
    try:
        _compile()
        import importlib

        importlib.invalidate_caches()
        _native = importlib.import_module("_native")
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        sys.stderr.write(f"sfft_jax: native build unavailable ({exc}); "
                         "using numpy fallbacks\n")
        _native = None
    return _native


def _compile():
    src = os.path.join(os.path.dirname(__file__), "_native.cc")
    bdir = _build_dir()
    os.makedirs(bdir, exist_ok=True)
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(bdir, "_native" + ext)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return
    include_py = sysconfig.get_path("include")
    include_np = np.get_include()
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{include_py}", f"-I{include_np}",
        src, "-o", out,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def hough_accum(x_idxs, y_idxs, ctheta, stheta, max_distance) -> np.ndarray:
    mod = _try_load()
    if mod is not None:
        return mod.hough_accum(
            np.ascontiguousarray(x_idxs, np.int64),
            np.ascontiguousarray(y_idxs, np.int64),
            np.ascontiguousarray(ctheta, np.float64),
            np.ascontiguousarray(stheta, np.float64),
            int(max_distance),
        )
    # numpy fallback: vectorized scatter-add with half-away-from-zero rounding
    x = np.asarray(x_idxs, np.float64)[:, None]
    y = np.asarray(y_idxs, np.float64)[:, None]
    v = ctheta[None, :] * x + stheta[None, :] * y
    idx = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)
    idx += max_distance // 2
    accum = np.zeros((max_distance, len(ctheta)), dtype=np.uint64)
    j = np.broadcast_to(np.arange(len(ctheta))[None, :], idx.shape)
    ok = (idx >= 0) & (idx < max_distance)
    np.add.at(accum, (idx[ok], j[ok]), 1)
    return accum


def label(mask, connectivity: int = 2):
    """Connected-component labeling; returns (labels int32, nlabels)."""
    mod = _try_load()
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if mod is not None:
        return mod.ccl_label(m, int(connectivity))
    from scipy import ndimage

    structure = np.ones((3, 3)) if connectivity == 2 else None
    lab, n = ndimage.label(m, structure=structure)
    return lab.astype(np.int32), int(n)


def rice_decode(data: bytes, npix: int, blocksize: int = 32) -> np.ndarray:
    """RICE_1 decode (BYTEPIX=4) -> int32[npix]; CFITSIO fits_rdecomp
    semantics. Pure-python fallback mirrors the C++ implementation."""
    mod = _try_load()
    if mod is not None and hasattr(mod, "rice_decode"):
        return mod.rice_decode(bytes(data), int(npix), int(blocksize))
    out = np.zeros(npix, dtype=np.int32)
    fsbits, fsmax, bbits = 5, 25, 32
    c = np.frombuffer(data, dtype=np.uint8)
    pos = 4
    lastpix = int(np.int32(int.from_bytes(data[:4], "big", signed=True)))
    b = int(c[pos]); pos += 1
    nbits = 8
    i = 0
    n = len(c)
    def nextbyte():
        nonlocal pos
        v = int(c[pos]) if pos < n else 0
        pos += 1
        return v
    while i < npix:
        nbits -= fsbits
        while nbits < 0:
            b = (b << 8) | nextbyte()
            nbits += 8
        fs = ((b >> nbits) & ((1 << fsbits) - 1)) - 1
        b &= (1 << nbits) - 1
        imax = min(i + blocksize, npix)
        if fs < 0:
            out[i:imax] = lastpix
            i = imax
        elif fs == fsmax:
            while i < imax:
                k = bbits - nbits
                diff = (b << k) & 0xFFFFFFFF if k < 32 else 0
                k -= 8
                while k >= 0:
                    b = nextbyte()
                    diff |= b << k
                    k -= 8
                if nbits > 0:
                    b = nextbyte()
                    diff |= b >> (-k)
                    b &= (1 << (k + 8)) - 1
                else:
                    b = 0
                d = ~(diff >> 1) if (diff & 1) else (diff >> 1)
                d = int(np.int32(np.uint32(d & 0xFFFFFFFF)))
                lastpix = int(np.int32(d + lastpix))
                out[i] = lastpix
                i += 1
        else:
            while i < imax:
                while b == 0:
                    nbits += 8
                    b = nextbyte()
                msb = b.bit_length() - 1
                nzero = nbits - (msb + 1)
                nbits = msb
                b &= (1 << nbits) - 1
                nbits -= fs
                while nbits < 0:
                    b = (b << 8) | nextbyte()
                    nbits += 8
                diff = (nzero << fs) | (b >> nbits)
                b &= (1 << nbits) - 1
                d = ~(diff >> 1) if (diff & 1) else (diff >> 1)
                lastpix = int(np.int32(d + lastpix))
                out[i] = lastpix
                i += 1
    return out
