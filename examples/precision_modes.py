"""Precision modes: the f64 CONTRACT default vs the FAST mode.

The reference (thomasvrussell/sfft) computes everything in float64. This
framework does the same by default and also offers an explicitly
mixed-precision fast mode (config.MODES):

  * CONTRACT (default): greek/fdiff/solver = 'fft'/'fft'/'lu'
      - complex128 FFT correlation tables and difference, equilibrated f64
        LU solve — the reference's semantics
  * FAST (opt-in, make_config(..., mode="fast")): 'peeled'/'fft32'/'refined'
      - smooth/fluctuation peel: exact moments + c64 FFT fluctuations, an
        f32 difference and an f32-factor solve with f64 refinement; its
        accuracy depends on the system's conditioning (PERF.md records what
        it reached on a GPU) — use CONTRACT for precision photometry.

Run: python examples/precision_modes.py [--cpu]
(on whatever backend JAX finds; --cpu pins the CPU)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from sfft_jax.config import make_config
from sfft_jax.core.engine import GeneralSFFT


def make_pair(n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    I = 200.0 * (1.0 + 0.2 * xx / n + 0.3 * (yy / n) ** 2)
    for _ in range(60):
        x0, y0 = rng.uniform(6, n - 6, 2)
        I += rng.uniform(200, 2000) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 1.8**2))
    J = 1.1 * I + 5.0 + rng.normal(0, 1.0, (n, n))
    return I + rng.normal(0, 1.0, (n, n)), J


def main():
    n = 512
    I, J = make_pair(n)

    # CONTRACT mode: just the defaults
    cfg = make_config(n, n, 6)
    print(f"contract config: greek={cfg.greek_backend} "
          f"fdiff={cfg.fdiff_backend} solver={cfg.solver}")
    t0 = time.time()
    sol_c, diff_c, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
    print(f"contract: {time.time()-t0:.2f}s  "
          f"diff RMS {float(jnp.sqrt(jnp.mean(jnp.asarray(diff_c)**2))):.4f}")

    # FAST mode: explicit opt-in
    cfg_f = make_config(n, n, 6, mode="fast")
    print(f"fast config: greek={cfg_f.greek_backend} "
          f"fdiff={cfg_f.fdiff_backend} solver={cfg_f.solver}")
    t0 = time.time()
    sol_f, diff_f, _ = GeneralSFFT.GSS(I, J, I, J, cfg_f)
    print(f"fast:     {time.time()-t0:.2f}s  "
          f"diff RMS {float(jnp.sqrt(jnp.mean(jnp.asarray(diff_f)**2))):.4f}")

    dev = np.max(np.abs(np.asarray(sol_c) - np.asarray(sol_f)))
    print(f"solution max abs deviation between modes: {dev:.3e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    if ap.parse_args().cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    main()
