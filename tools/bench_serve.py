"""Measure the resident-engine-server path (sfft_jax/serve.py) on a GPU.

The number that matters: a FRESH survey job's time-to-first-difference when a
machine-resident engine server already holds the card and the compiled step.
Without the server every new process pays JAX start-up, backend
initialization and the compile; with it a new job is IPC + H2D + compute.
This process and the fresh client stay off JAX's device backend: the server
is the only process on the card.

Protocol:
  1. ensure_server() spawns the daemon.
  2. client.warm(cfg) compiles + first-dispatches the fused 4K step inside
     the server.
  3. a FRESH client process (separate Python, no jax backend init) loads the
     pair from disk, connects, runs subtract, writes its wall time — the
     headline "new job" number.
  4. a second in-process subtract gives the steady round-trip number.

Usage: python tools/bench_serve.py [--n 4096] [--mode contract|fast]
       [--socket PATH] [--keep]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--mode", choices=("contract", "fast"), default="contract")
    ap.add_argument("--socket", default=os.path.join(
        tempfile.gettempdir(), "sfft_engine_bench.sock"))
    ap.add_argument("--keep", action="store_true",
                    help="leave the server running afterwards")
    ap.add_argument("--platform", default=None,
                    help="force server platform (e.g. cpu for a dry run)")
    args = ap.parse_args()

    from sfft_jax.config import MODES, make_config
    from sfft_jax.serve import EngineClient, ensure_server
    from sfft_jax.utils.synth import star_pair

    env = dict(os.environ)
    if args.platform:
        env["SFFT_SERVE_PLATFORM"] = args.platform

    t0 = time.time()
    resp = ensure_server(args.socket, spawn_timeout=600.0, env=env)
    log(f"server up on {args.socket} (pid {resp['pid']}, platform "
        f"{resp['platform']}) after {time.time()-t0:.1f}s")

    # the mode's backend triple, pinned explicitly (fft/fft/lu for contract)
    over = dict(MODES[args.mode])
    cfg = make_config(args.n, args.n, args.w, dtype="float64", **over)

    with EngineClient(args.socket) as c:
        t0 = time.time()
        warm_s = c.warm(cfg)
        log(f"server warm({args.mode} {args.n}^2): {warm_s:.1f}s server-side "
            f"({time.time()-t0:.1f}s wall)")

        I, J = star_pair(args.n, args.n)
        pair_file = os.path.join(tempfile.gettempdir(),
                                 f"sfft_serve_pair_{args.n}.npz")
        np.savez(pair_file, I=I, J=J)

        # headline: fresh client process, disk -> diff
        script = textwrap.dedent(f"""
            import sys, time, numpy as np
            t0 = time.time()
            sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
            from sfft_jax.config import make_config
            from sfft_jax.serve import EngineClient
            cfg = make_config({args.n}, {args.n}, {args.w}, dtype="float64",
                              **{over!r})
            d = np.load({pair_file!r})
            with EngineClient({args.socket!r}) as c:
                sol, diff, _ = c.subtract(d["I"], d["J"], cfg,
                                          diff_dtype="float32")
            rms = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
            print(time.time() - t0, rms)
        """)
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=3600,
                             env=dict(os.environ))
        if out.returncode != 0:
            log(out.stdout + out.stderr)
            raise SystemExit("fresh-client probe failed")
        fresh_s, rms = map(float, out.stdout.split())
        log(f"FRESH-JOB time-to-first-difference via server: {fresh_s:.2f}s "
            f"(outer wall {time.time()-t0:.2f}s), diff RMS {rms:.4f}")

        # steady round trip, same connection
        t0 = time.time()
        _sol, diff, _ = c.subtract(I, J, cfg, diff_dtype="float32")
        steady_s = time.time() - t0
        log(f"steady client round-trip: {steady_s:.2f}s")

        if not args.keep:
            c.shutdown()

    print(json.dumps({
        "metric": f"serve_fresh_job_first_diff_{args.n}_{args.mode}",
        "value": round(fresh_s, 3),
        "unit": "s",
        "extra": {"server_warm_s": round(warm_s, 2),
                  "steady_round_trip_s": round(steady_s, 3),
                  "diff_rms": rms},
    }))


if __name__ == "__main__":
    main()
