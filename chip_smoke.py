#!/usr/bin/env python3
"""Smoke run of the subtraction main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --engines     # one card: opt-in engines vs native f64
    python chip_smoke.py --four-cards  # four cards: survey mesh + sharded pair

Default phases (one card, float64 throughout):
  1. device    fail unless JAX's first device is a GPU; print the card's name
               and power limit, the JAX version and the x64 switch;
  2. poly 4096 a seeded 4096^2 pair (GKerHW=8, polynomial degree 2/2, NEQ
               1740) as FITS through CustomizedPacket.CP; compile time,
               memory analysis, steady times and peak memory; the normwise
               backward error of the card's solution on the card's own normal
               equations must be <= 1e-12;
  3. poly 1024 the same generator and config on the GPU and on the CPU device
               of this process: difference RMS deviation <= 1e-6 (solution
               deviation reported, not gated: near-null LU directions of the
               raw-conditioned system wobble between LU implementations);
  4. bspline   a seeded 900^2 NIRCam-shaped pair through BSplinePacket.BSP
               (GKerHW=11, 13,226 unknowns, Tikhonov-regularized) on the GPU and
               on the CPU device: difference RMS and solution max-rel <= 1e-6;
  5. gpu tests the test suite's `gpu`-marked tests, in this process.

Every phase raises on failure; the last line of standard output is one JSON
object naming the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")

DIFF_RMS_BOUND = 1e-6        # BASELINE.md parity contract
BSPLINE_SOL_BOUND = 1e-6     # regularized system: solutions must agree too
BACKWARD_ERROR_BOUND = 1e-12
MESH_DIFF_RMS_BOUND = 1e-9   # the same batched program on one card vs four


def log(msg: str) -> None:
    print(msg, flush=True)


def check(*items) -> None:
    """items: (name, value, bound) with bound None for a value that is
    reported, not gated. Prints every value beside its bound first, then
    raises for the first one that misses."""
    failed = []
    for name, value, bound in items:
        if bound is None:
            log(f"  {name}: {value:.3e} (reported, not gated)")
            continue
        ok = bool(np.isfinite(value) and value <= bound)
        log(f"  {name}: {value:.3e} (bound {bound:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} = {value:.3e} exceeds {bound:.0e}")
    if failed:
        raise AssertionError("; ".join(failed))


def median_time(fn, reps: int = 3):
    """Median wall time of `reps` calls of fn, each ended by
    jax.block_until_ready; returns (seconds, last output)."""
    import jax

    ts, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpus(count: int):
    """The first `count` GPU devices; raises SystemExit when JAX finds no
    such accelerator (no fallback to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's first device is "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, JAX finds "
                         f"{len(devs)}")
    return devs[:count]


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def memory_summary(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "not reported"
    gib = 1 << 30
    return (f"args {m.argument_size_in_bytes / gib:.3f} GiB, "
            f"out {m.output_size_in_bytes / gib:.3f} GiB, "
            f"temp {m.temp_size_in_bytes / gib:.3f} GiB, "
            f"code {m.generated_code_size_in_bytes / gib:.4f} GiB")


# --------------------------------------------------------------------------
# checks shared with the CPU tests
# --------------------------------------------------------------------------


def pair_deviation(sol_a, diff_a, sol_b, diff_b):
    """(solution max-rel deviation, difference RMS deviation) of run a
    against reference run b."""
    sol_a = np.asarray(sol_a, np.float64)
    sol_b = np.asarray(sol_b, np.float64)
    e = np.asarray(diff_a, np.float64) - np.asarray(diff_b, np.float64)
    sol_rel = float(np.max(np.abs(sol_a - sol_b)) / np.max(np.abs(sol_b)))
    return sol_rel, float(np.sqrt(np.nanmean(e * e)))


def solution_backward_error(cfg, mI, mJ, sol) -> float:
    """Normwise backward error of `sol` on the normal equations of the masked
    pair (mI, mJ), assembled in f64 on the device that holds the inputs."""
    import jax
    import jax.numpy as jnp

    from sfft_jax.core.engine import normal_equations_fn
    from sfft_jax.core.solve import backward_error

    def fn(mI, mJ, sol):
        lhs, rhs = normal_equations_fn(cfg)(mI, mJ)
        return backward_error(cfg, lhs, rhs, sol)

    return float(jax.jit(fn)(jnp.asarray(mI), jnp.asarray(mJ),
                             jnp.asarray(sol)))


def fused_step(cfg, I, J, dev):
    """Compile the fused same-pair solve+subtract step for (I, J) resident
    on `dev`; returns (step, compile seconds, memory analysis) with step()
    running it once."""
    import jax

    from sfft_jax.core.engine import solve_and_subtract_same_fn

    Id = jax.device_put(I, dev)
    Jd = jax.device_put(J, dev)
    t0 = time.perf_counter()
    compiled = jax.jit(solve_and_subtract_same_fn(cfg)).lower(Id, Jd).compile()
    compile_s = time.perf_counter() - t0
    return (lambda: compiled(Id, Jd)), compile_s, memory_summary(compiled)


def write_pair_fits(tag: str, I: np.ndarray, J: np.ndarray):
    """Write ref/sci and their (identical, NaN-free) masked copies as FITS
    under the work directory; returns the four paths."""
    from sfft_jax.io import fits

    os.makedirs(WORK, exist_ok=True)
    paths = [os.path.join(WORK, f"{tag}_{k}.fits")
             for k in ("ref", "sci", "mref", "msci")]
    for p, a in zip(paths, (I, J, I, J)):
        fits.write(p, np.ascontiguousarray(a.T, np.float64))
    return paths


# --------------------------------------------------------------------------
# default phases
# --------------------------------------------------------------------------


def phase_device(count: int = 1):
    import jax

    devs = require_gpus(count)
    log(f"card: {gpu_name_and_power()}")
    log(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
        f"{devs[0].device_kind}; x64 {'on' if jax.config.jax_enable_x64 else 'off'}")
    if not jax.config.jax_enable_x64:
        raise AssertionError("x64 is off")
    return devs


def phase_poly(gpu, n: int = 4096, w: int = 8, seed: int = 0,
               bound: float = BACKWARD_ERROR_BOUND):
    """CustomizedPacket.CP on an n^2 pair: times, memory and the backward
    error of the card's solution."""
    import jax

    from sfft_jax import CustomizedPacket, make_config
    from sfft_jax.io import fits
    from sfft_jax.utils.synth import star_pair

    log(f"[poly {n}] GKerHW={w}, polynomial 2/2")
    I, J = star_pair(n, n, seed=seed)
    paths = write_pair_fits(f"poly{n}", I, J)
    cfg = make_config(n, n, w)
    triple = (cfg.greek_backend, cfg.fdiff_backend, cfg.solver)
    log(f"  config: NEQ {cfg.NEQ}; greek/fdiff/solver = {'/'.join(triple)}")
    if triple != ("fft", "fft", "lu"):
        raise AssertionError(f"default config resolved to {triple}")

    t_dev = report_fused_step(cfg, I, J, gpu)

    # the user's entry point, FITS in and FITS out
    diff_path = os.path.join(WORK, f"poly{n}_diff.fits")
    t0 = time.perf_counter()
    sol, diff = CustomizedPacket.CP(*paths, "REF", w, FITS_DIFF=diff_path)
    log(f"  CustomizedPacket.CP first call (compiles): "
        f"{time.perf_counter() - t0:.3f} s")
    t_cp, (sol, diff) = median_time(
        lambda: CustomizedPacket.CP(*paths, "REF", w, FITS_DIFF=diff_path))
    log(f"  CustomizedPacket.CP FITS to FITS: median of 3 {t_cp:.4f} s")
    log(f"  peak device memory so far: {peak_bytes(gpu) / (1 << 30):.3f} GiB")
    if diff.shape != (n, n) or not np.all(np.isfinite(diff)):
        raise AssertionError("difference image not finite or misshapen")

    mI = fits.getdata(paths[2]).T.astype(np.float64)
    mJ = fits.getdata(paths[3]).T.astype(np.float64)
    with jax.default_device(gpu):
        eta = solution_backward_error(cfg, mI, mJ, sol)
    check((f"poly {n} backward error of the card's solution", eta, bound))
    return dict(device_step_s=t_dev, cp_s=t_cp, backward_error=eta)


def report_fused_step(cfg, I, J, dev) -> float:
    """Compile time, memory analysis and median steady time of the fused
    device-resident step; returns the time."""
    step, compile_s, memory = fused_step(cfg, I, J, dev)
    log(f"  fused step compile: {compile_s:.3f} s")
    log(f"  fused step memory analysis: {memory}")
    t_dev, _ = median_time(step)
    log(f"  fused solve+subtract, device-resident: median of 3 {t_dev:.4f} s")
    return t_dev


def gpu_cpu_parity(run, gpu, cpu, tag: str, sol_bound=None):
    """Run `run()` -> (sol, diff) on the GPU and on the CPU device of this
    process and compare; returns (sol_rel, diff_rms)."""
    import jax

    with jax.default_device(gpu):
        sol_g, diff_g = run()          # warm (compiles)
        t_g, (sol_g, diff_g) = median_time(run)
    log(f"  [{tag}] GPU: median of 3 {t_g:.4f} s")
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        sol_c, diff_c = run()
    log(f"  [{tag}] CPU oracle (compile + one run): "
        f"{time.perf_counter() - t0:.3f} s")
    sol_rel, rms = pair_deviation(sol_g, diff_g, sol_c, diff_c)
    check((f"{tag} difference RMS, GPU vs CPU", rms, DIFF_RMS_BOUND),
          (f"{tag} solution max-rel, GPU vs CPU", sol_rel, sol_bound))
    return sol_rel, rms


def phase_poly_parity(gpu, cpu, n: int = 1024, w: int = 8, seed: int = 1):
    from sfft_jax import CustomizedPacket, make_config
    from sfft_jax.utils.synth import star_pair

    log(f"[poly {n} parity] GKerHW={w}, polynomial 2/2")
    I, J = star_pair(n, n, seed=seed)
    paths = write_pair_fits(f"poly{n}", I, J)
    cfg = make_config(n, n, w)
    return gpu_cpu_parity(
        lambda: CustomizedPacket.CP(*paths, "REF", w, cfg=cfg),
        gpu, cpu, f"poly {n}")


def phase_bspline(gpu, cpu, n: int = 900, w: int = 11, seed: int = 2):
    from sfft_jax.api.bspline import BSplinePacket, make_bspline_config
    from sfft_jax.utils.synth import nircam_bspline_kwargs, star_pair

    I, J = star_pair(n, n, seed=seed, sigma_ref=1.4, sigma_sci=1.9)
    paths = write_pair_fits(f"bspline{n}", I, J)
    cfg = make_bspline_config(n, n, w, **nircam_bspline_kwargs(n, n))
    triple = (cfg.greek_backend, cfg.fdiff_backend, cfg.solver)
    log(f"[bspline {n}] GKerHW={w}, B-spline 2 with 2x2 knots, NEQ {cfg.NEQ}; "
        f"greek/fdiff/solver = {'/'.join(triple)}")
    if triple != ("fft", "fft", "lu"):
        raise AssertionError(f"B-spline config resolved to {triple}")

    report_fused_step(cfg, I, J, gpu)
    out = gpu_cpu_parity(
        lambda: BSplinePacket.BSP(*paths, ForceConv="REF", GKerHW=w, cfg=cfg),
        gpu, cpu, f"bspline {n}", sol_bound=BSPLINE_SOL_BOUND)
    log(f"  peak device memory so far: {peak_bytes(gpu) / (1 << 30):.3f} GiB")
    return out


def phase_gpu_tests():
    """The test suite's `gpu`-marked tests, in this process (a second
    process could not get the card's memory)."""
    import pytest

    log("[gpu tests] pytest -m gpu tests/test_gpu.py")
    os.environ["SFFT_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit code {rc})")


# --------------------------------------------------------------------------
# --engines: opt-in engine families against the native f64 path
# --------------------------------------------------------------------------

ENGINE_FAMILIES = {
    "exact": dict(greek_backend="exact", fdiff_backend="exact",
                  solver="exact"),
    "pexact": dict(greek_backend="pexact", fdiff_backend="pexact",
                   solver="exact"),
    "fast": dict(greek_backend="peeled", fdiff_backend="fft32",
                 solver="refined"),
    # fast mode's tables and difference with the f64 LU solve: separates
    # the table error from the f32-factor solver's
    "fast-tables+lu": dict(greek_backend="peeled", fdiff_backend="fft32",
                           solver="lu"),
}


def phase_engines(gpu):
    from sfft_jax import make_config
    from sfft_jax.utils.synth import star_pair

    failures = []
    for n in (1024, 4096):
        I, J = star_pair(n, n, seed=3)
        native, c_s, _ = fused_step(make_config(n, n, 8), I, J, gpu)
        t_nat, (sol_n, diff_n) = median_time(native)
        log(f"[engines {n}] native fft/fft/lu: compile {c_s:.3f} s, "
            f"median of 3 {t_nat:.4f} s")
        for fam, knobs in ENGINE_FAMILIES.items():
            try:
                step, c_s, _ = fused_step(make_config(n, n, 8, **knobs),
                                          I, J, gpu)
                t, (sol, diff) = median_time(step)
                sol_rel, rms = pair_deviation(sol, diff, sol_n, diff_n)
                log(f"[engines {n}] {fam}: compile {c_s:.3f} s, median of 3 "
                    f"{t:.4f} s ({t / t_nat:.2f}x native); vs native: "
                    f"solution max-rel {sol_rel:.3e}, difference RMS "
                    f"{rms:.3e}")
                del step
            except Exception as exc:  # the A/B records which families fail
                failures.append(f"{fam}@{n}")
                log(f"[engines {n}] {fam}: FAILED {type(exc).__name__}: "
                    f"{str(exc)[:400]}")
        del native
        log(f"  peak device memory so far: "
            f"{peak_bytes(gpu) / (1 << 30):.3f} GiB")
    phase_greek_methods(gpu)
    phase_moments_matmul(gpu)
    if failures:
        raise AssertionError(f"engine families failed: {failures}")


def phase_greek_methods(gpu, n: int = 4096, w: int = 8):
    """corr_window_fft 'matmul' (partial inverse DFT as two c128 einsums)
    against 'irfft' (full inverse FFT + corner gather) on the correlation
    calls of a polynomial 2/2 config."""
    import jax
    import jax.numpy as jnp

    from sfft_jax import make_config
    from sfft_jax.core.engine import _plane_stacks
    from sfft_jax.core.greek import corr_window_fft
    from sfft_jax.utils.synth import star_pair

    cfg = make_config(n, n, w)
    I, J = star_pair(n, n, seed=4)
    SI, ST, _ = _plane_stacks(cfg, jax.device_put(jnp.asarray(I), gpu))
    Jd = jax.device_put(jnp.asarray(J), gpu)
    specs = jax.jit(jnp.fft.rfft2)(jnp.concatenate([Jd[None], SI, ST]))
    F = SI.shape[0]
    outs = {}
    for method in ("matmul", "irfft"):
        def tables(specs, method=method):
            sJ, sI, sT = specs[:1], specs[1:1 + F], specs[1 + F:]
            return (corr_window_fft(sI, sI, n, n, 2 * w, 2 * w,
                                    symmetric=True, method=method),
                    corr_window_fft(sI, sT, n, n, w, w, method=method),
                    corr_window_fft(sI, sJ, n, n, w, w, method=method))

        fn = jax.jit(tables)
        jax.block_until_ready(fn(specs))
        t, outs[method] = median_time(lambda: fn(specs))
        log(f"[greek {n}] corr_window_fft method={method}: median of 3 "
            f"{t:.4f} s")
    dev = max(float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
              for a, b in zip(outs["matmul"], outs["irfft"]))
    log(f"[greek {n}] matmul vs irfft tables: max-rel {dev:.3e}")


def phase_moments_matmul(gpu, n: int = 4096, sg: int = 8):
    """The peeled engine's moment product P0 @ G in plain f64."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    P0 = jax.device_put(jnp.asarray(rng.random((sg, n))), gpu)
    G = jax.device_put(jnp.asarray(rng.normal(size=(n, n))), gpu)
    fn = jax.jit(lambda a, b: a @ b)
    jax.block_until_ready(fn(P0, G))
    t, out = median_time(lambda: fn(P0, G), reps=20)
    ref = np.asarray(P0) @ np.asarray(G)
    rel = float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))
    log(f"[moments] f64 P0 ({sg}x{n}) @ G ({n}x{n}): median of 20 "
        f"{t * 1e6:.1f} us; max-rel vs numpy {rel:.3e}")


# --------------------------------------------------------------------------
# --four-cards: the survey mesh and the row-sharded single pair
# --------------------------------------------------------------------------


def phase_four_cards(gpus, n_pairs: int = 16, n: int = 2048,
                     n_big: int = 4096, w: int = 8):
    import jax

    from sfft_jax import make_config
    from sfft_jax.core.engine import solve_and_subtract_fn
    from sfft_jax.parallel.batch import batched_subtract, make_data_mesh
    from sfft_jax.parallel.sharded_fft import sharded_subtract_step
    from sfft_jax.utils.synth import star_pair

    mesh = make_data_mesh(devices=gpus)
    cfg = make_config(n, n, w)
    pairs = [star_pair(n, n, seed=100 + k) for k in range(n_pairs)]
    Is = np.stack([p[0] for p in pairs])
    Js = np.stack([p[1] for p in pairs])
    del pairs
    log(f"[mesh] {n_pairs} pairs of {n}^2 over {len(gpus)} cards "
        f"(GKerHW={w}, polynomial 2/2, NEQ {cfg.NEQ})")
    run = lambda: batched_subtract(Is, Js, Is, Js, cfg, mesh)  # noqa: E731
    t0 = time.perf_counter()
    sols, diffs, _ = jax.block_until_ready(run())
    log(f"  first call (compiles): {time.perf_counter() - t0:.3f} s")
    t_mesh, (sols, diffs, _) = median_time(run)
    log(f"  batched_subtract: median of 3 {t_mesh:.4f} s "
        f"({n_pairs / t_mesh:.3f} pairs/s)")
    shard_devs = sorted({d.id for s in diffs.addressable_shards
                         for d in [s.device]})
    log(f"  difference stack shards on devices {shard_devs}")
    if len(shard_devs) != len(gpus):
        raise AssertionError("the batch did not spread over every card")
    for d in gpus:
        log(f"  card {d.id} peak memory: {peak_bytes(d) / (1 << 30):.3f} GiB")

    # the same batched program on one card, one device's share at a time:
    # the mesh must reproduce it (an unbatched single-pair step differs by
    # the batched-vs-single LU rounding band, ~5e-9 RMS at 2048^2)
    mesh1 = make_data_mesh(devices=gpus[:1])
    per = n_pairs // len(gpus)
    worst = 0.0
    for k in range(0, n_pairs, per):
        sl = slice(k, k + per)
        _, d1, _ = batched_subtract(Is[sl], Js[sl], Is[sl], Js[sl], cfg,
                                    mesh1)
        e = np.asarray(diffs[sl]) - np.asarray(d1)
        worst = max(worst, float(np.max(np.sqrt(np.mean(e * e,
                                                        axis=(1, 2))))))
    log(f"  mesh vs one-card difference RMS (worst pair): {worst:.3e}")
    del sols, diffs, Is, Js

    I, J = star_pair(n_big, n_big, seed=200)
    cfg_big = make_config(n_big, n_big, w)
    log(f"[sharded pair] one {n_big}^2 pair row-sharded over "
        f"{len(gpus)} cards")
    run_sh = sharded_subtract_step(cfg_big, mesh)
    t0 = time.perf_counter()
    jax.block_until_ready(run_sh(I, J, I, J))
    log(f"  first call (compiles): {time.perf_counter() - t0:.3f} s")
    t_sh, (sol_sh, diff_sh) = median_time(lambda: run_sh(I, J, I, J))
    log(f"  sharded_subtract_step: median of 3 {t_sh:.4f} s")
    with jax.default_device(gpus[0]):
        big = jax.jit(solve_and_subtract_fn(cfg_big))
        jax.block_until_ready(big(I, J, I, J))
        t_1, (sol_1, diff_1) = median_time(lambda: big(I, J, I, J))
    log(f"  one card: median of 3 {t_1:.4f} s")
    for d in gpus:
        log(f"  card {d.id} peak memory: {peak_bytes(d) / (1 << 30):.3f} GiB")
    sol_rel, rms = pair_deviation(sol_sh, diff_sh, sol_1, diff_1)
    # the sharded program partitions the FFTs and differs in rounding, so
    # it is held to the parity contract
    check(("mesh vs one-card difference RMS (worst pair)", worst,
           MESH_DIFF_RMS_BOUND),
          ("sharded vs one-card solution max-rel", sol_rel, None),
          ("sharded vs one-card difference RMS", rms, DIFF_RMS_BOUND))


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the four-card mesh phases")
    mode.add_argument("--engines", action="store_true",
                      help="time the opt-in engine families on one card")
    args = ap.parse_args(argv)

    import jax

    import sfft_jax  # noqa: F401  (switches x64 on)

    count = 4 if args.four_cards else 1
    devs = phase_device(count)
    try:
        if args.four_cards:
            phase_four_cards(devs)
        elif args.engines:
            phase_engines(devs[0])
        else:
            cpu = jax.devices("cpu")[0]
            phase_poly(devs[0])
            phase_poly_parity(devs[0], cpu)
            phase_bspline(devs[0], cpu)
            phase_gpu_tests()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
