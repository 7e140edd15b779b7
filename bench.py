"""Headline benchmark: one 4096^2 pair through the default f64 path on a GPU.

Runs the fused solve+subtract step of make_config(4096, 4096, 8) — complex128
FFT tables, LU solve, complex128 difference (GKerHW=8, polynomial 2/2, NEQ
1740) — on a seeded star-field pair resident on the card, and prints ONE
JSON line naming the card. Fails when JAX finds no GPU; there is no CPU
fallback.

Outside yardstick (BASELINE.md): the reference's CuPy f64 path does a 4096^2
pair in ~1.35 s on an NVIDIA A100; vs_baseline > 1 means faster than that.

    python bench.py
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_4K_S = 1.35


def main(n: int = 4096, w: int = 8, reps: int = 5) -> int:
    import jax

    from sfft_jax import make_config
    from sfft_jax.core.engine import solve_and_subtract_fn
    from sfft_jax.utils.synth import star_pair

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX's first device is "
                         f"{dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    cfg = make_config(n, n, w)
    I, J = star_pair(n, n)
    Id = jax.device_put(I, dev)
    Jd = jax.device_put(J, dev)
    t0 = time.perf_counter()
    step = jax.jit(solve_and_subtract_fn(cfg)).lower(Id, Jd, Id, Jd).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(step(Id, Jd, Id, Jd))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol, diff = jax.block_until_ready(step(Id, Jd, Id, Jd))
        ts.append(time.perf_counter() - t0)
    if not (np.all(np.isfinite(np.asarray(sol)))
            and np.all(np.isfinite(np.asarray(diff)))):
        raise SystemExit("bench: non-finite solution or difference")
    t = float(np.median(ts))
    print(json.dumps({
        "metric": f"{n}x{n}_f64_subtract_wall",
        "value": t,
        "unit": "s",
        "vs_baseline": BASELINE_4K_S / t if n == 4096 else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "extra": {"compile_s": compile_s, "times_s": ts, "NEQ": cfg.NEQ,
                  "backends": [cfg.greek_backend, cfg.fdiff_backend,
                               cfg.solver]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
