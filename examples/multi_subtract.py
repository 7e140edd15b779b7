"""Survey-mode multi-task example (reference test/subtract_test_multiprocessing).

Copies one synthetic pair into NUM_TASK task slots and runs the multi-task
scheduler, printing the success count and total wall time exactly like
multiple_subtract_sparse_flavor.py. Also demonstrates the homogeneous fast
path: the same tasks batched over the device mesh.

Run: python examples/multi_subtract.py [--tasks 8] [--mesh] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as pa
import sys
import time

import numpy as np

sys.path.insert(0, pa.dirname(pa.dirname(pa.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--mesh", action="store_true",
                    help="use the sharded-mesh homogeneous batch path")
    ap.add_argument("--pack", action="store_true",
                    help="with --mesh: ship the pairs as int16 + per-block "
                         "scales (half the H2D bytes of f32; FAST-mode "
                         "accuracy floor only — see utils/pack.py)")
    ap.add_argument("--out", default="/tmp/multi_out")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from sfft_jax.io import fits
    from sfft_jax.config import make_config

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    n = args.size
    pairs = []
    for t in range(args.tasks):
        ref = 100.0 + rng.normal(0, 2.0, (n, n))
        for _ in range(60):
            x0, y0 = rng.integers(8, n - 8, 2)
            gx, gy = np.mgrid[-5:6, -5:6]
            ref[x0 - 5 : x0 + 6, y0 - 5 : y0 + 6] += (
                rng.uniform(500, 5000) / 9.0 * np.exp(-(gx**2 + gy**2) / 4.5))
        sci = 1.05 * ref + 3.0 + rng.normal(0, 1.0, (n, n))
        pairs.append((ref, sci))

    cfg = make_config(n, n, 4)

    if args.mesh:
        from sfft_jax.parallel.batch import (batched_subtract,
                                             batched_subtract_packed,
                                             make_data_mesh)

        ndev = jax.device_count()
        mesh = make_data_mesh(min(ndev, args.tasks))
        I = np.stack([p[0] for p in pairs])
        J = np.stack([p[1] for p in pairs])
        if args.pack:
            # int16 H2D packing needs a FAST-grade config (quantization is
            # invisible only below fast's own accuracy floor)
            import dataclasses

            cfg_fast = dataclasses.replace(
                cfg, greek_backend="peeled", fdiff_backend="fft32",
                solver="refined")
            t0 = time.time()
            sols, diffs, rms = batched_subtract_packed(
                I, J, I, J, cfg_fast, mesh)
        else:
            t0 = time.time()
            sols, diffs, rms = batched_subtract(I, J, I, J, cfg, mesh)
        rms = np.asarray(rms)
        print(f"mesh batch{' (int16-packed H2D)' if args.pack else ''}: "
              f"{args.tasks} pairs over {mesh.devices.size} devices "
              f"in {time.time()-t0:.2f}s; diff RMS {rms.min():.3f}..{rms.max():.3f}")
        return

    from sfft_jax.parallel.scheduler import MultiTaskScheduler, STATUS_OK
    from sfft_jax.core.engine import GeneralSFFT

    def prep_fn(tid):
        return pairs[tid]

    def subtract_fn(tid, prep):
        ref, sci = prep
        sol, diff, _ = GeneralSFFT.GSS(ref, sci, ref, sci, cfg)
        fits.write(f"{args.out}/diff_{tid:02d}.fits", np.asarray(diff).T)
        return float(np.sqrt(np.mean(np.asarray(diff) ** 2)))

    t0 = time.time()
    sched = MultiTaskScheduler(args.tasks, prep_fn, subtract_fn,
                               NUM_THREADS_4PREPROC=2, NUM_THREADS_4SUBTRACT=1)
    status, products = sched.run()
    ok = sum(1 for s in status.values() if s == STATUS_OK)
    print(f"NUM_SUCCESS [{ok} / {args.tasks}] in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
