"""Survey-mode parallelism: mesh batching + multi-task scheduler semantics."""

import os
import os.path as pa
import time

import numpy as np
import pytest

import sfft_jax  # noqa: F401
import jax


def test_batched_subtract_on_mesh(rng):
    from sfft_jax.config import SFFTConfig, BasisSpec
    from sfft_jax.parallel.batch import batched_subtract, make_data_mesh
    from tests.test_engine import make_pair, base_cfg
    from sfft_jax.core.engine import ElementalSFFT

    n_dev = jax.device_count()
    assert n_dev == 8, "conftest should provide 8 virtual cpu devices"
    cfg = base_cfg(N0=32, N1=32, w=1)
    Is, Js = [], []
    for k in range(8):
        I, J = make_pair(rng, N0=32, N1=32)
        Is.append(I)
        Js.append(J)
    I = np.stack(Is)
    J = np.stack(Js)
    mesh = make_data_mesh(8)
    sols, diffs, rms = batched_subtract(I, J, I, J, cfg, mesh)
    assert sols.shape == (8, cfg.NEQ)
    # batched result matches single-pair result
    sol0, diff0 = ElementalSFFT.ESS(Is[0], Js[0], cfg, Subtract=True)
    np.testing.assert_allclose(np.asarray(sols[0]), np.asarray(sol0),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(diffs[0]), np.asarray(diff0),
                               rtol=1e-7, atol=1e-9)


def test_scheduler_status_and_failures():
    from sfft_jax.parallel.scheduler import (
        MultiTaskScheduler, STATUS_OK, STATUS_FAIL, STATUS_PREP_FAIL)

    def prep_fn(tid):
        if tid == 2:
            raise RuntimeError("prep boom")
        return {"data": tid * 10}

    def subtract_fn(tid, prep):
        if tid == 3:
            raise RuntimeError("sub boom")
        return prep["data"] + 1

    sched = MultiTaskScheduler(5, prep_fn, subtract_fn,
                               NUM_THREADS_4PREPROC=2,
                               NUM_THREADS_4SUBTRACT=2, VERBOSE_LEVEL=0)
    status, products = sched.run()
    assert status[0] == STATUS_OK and products[0]["result"] == 1
    assert status[1] == STATUS_OK and products[1]["result"] == 11
    assert status[2] == STATUS_PREP_FAIL
    assert status[3] == STATUS_FAIL
    assert status[4] == STATUS_OK and products[4]["result"] == 41


def test_scheduler_timeout():
    from sfft_jax.parallel.scheduler import (
        MultiTaskScheduler, STATUS_OK, STATUS_FAIL)

    def prep_fn(tid):
        return tid

    def subtract_fn(tid, prep):
        if tid == 0:
            t0 = time.time()
            while time.time() - t0 < 10:  # interruptible busy loop
                sum(range(1000))
        return "done"

    sched = MultiTaskScheduler(2, prep_fn, subtract_fn,
                               NUM_THREADS_4PREPROC=1,
                               NUM_THREADS_4SUBTRACT=1,
                               TIMEOUT_4SUBTRACT_EACHTASK=0.5,
                               VERBOSE_LEVEL=0)
    t0 = time.time()
    status, products = sched.run()
    assert time.time() - t0 < 8
    assert status[0] == STATUS_FAIL
    assert status[1] == STATUS_OK


def test_multiproc_threading_map():
    from sfft_jax.utils.multiproc import MultiProc

    out = MultiProc.MP(list(range(20)), lambda t: t * t, nproc=4,
                       mode="threading")
    assert out == {t: t * t for t in range(20)}


def test_sharded_fft2_matches_local():
    rng = np.random.default_rng(5)
    import jax.numpy as jnp
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.sharded_fft import sharded_fft2

    mesh = make_data_mesh(8)
    x = rng.normal(size=(64, 48)) + 1j * rng.normal(size=(64, 48))
    out = sharded_fft2(jnp.asarray(x), mesh)
    ref = np.fft.fft2(x)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10, atol=1e-8)


def test_sharded_subtract_step():
    rng = np.random.default_rng(6)
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.sharded_fft import sharded_subtract_step
    from tests.test_engine import make_pair, base_cfg
    from sfft_jax.core.engine import ElementalSFFT

    mesh = make_data_mesh(8)
    cfg = base_cfg(N0=64, N1=64, w=1)
    I, J = make_pair(rng, N0=64, N1=64)
    run = sharded_subtract_step(cfg, mesh)
    sol, diff = run(I, J, I, J)
    sol_ref, diff_ref = ElementalSFFT.ESS(I, J, cfg, Subtract=True)
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(diff), np.asarray(diff_ref),
                               rtol=1e-7, atol=1e-9)


def test_mesp_prep_overlaps_subtract(tmp_path, monkeypatch):
    """MESP must run preprocessing in the prep stage (not folded into the
    subtract stage), so prep of later tasks overlaps subtraction of earlier
    ones (reference MultiEasySparsePacket.py:930-940)."""
    from sfft_jax.api.easy_sparse import EasySparsePacket
    from sfft_jax.parallel.scheduler import MultiEasySparsePacket, STATUS_OK

    events = []

    def fake_prep(FITS_REF, FITS_SCI, **kw):
        tid = int(FITS_REF[-6])
        events.append(("prep_start", tid, time.time()))
        time.sleep(0.3 if tid == 1 else 0.05)
        events.append(("prep_end", tid, time.time()))
        return {"tid": tid}

    def fake_subtract(prep, FITS_REF, **kw):
        tid = prep["tid"]
        events.append(("sub_start", tid, time.time()))
        time.sleep(0.1)
        events.append(("sub_end", tid, time.time()))
        return tid

    monkeypatch.setattr(EasySparsePacket, "ESP_Prep", staticmethod(fake_prep))
    monkeypatch.setattr(EasySparsePacket, "ESP_Subtract", staticmethod(fake_subtract))

    refs = [f"/fake/ref{t}.fits" for t in range(2)]
    scis = [f"/fake/sci{t}.fits" for t in range(2)]
    mesp = MultiEasySparsePacket(refs, scis)
    status, products = mesp.MESP(NUM_THREADS_4PREPROC=2,
                                 NUM_THREADS_4SUBTRACT=1, VERBOSE_LEVEL=0)
    assert all(s == STATUS_OK for s in status.values())
    t = {(kind, tid): tt for kind, tid, tt in events}
    # subtraction of task 0 started while prep of task 1 was still running
    assert t[("sub_start", 0)] < t[("prep_end", 1)]
    # and the prep product flowed into the subtract stage
    assert products[0]["result"] == 0 and products[1]["result"] == 1


def test_mesh_batch_streams_groups(monkeypatch):
    """MESH_BATCH mode must NOT barrier on the whole prep pool: a group is
    dispatched to the mesh the moment it fills, overlapping device work with
    preprocessing of later tasks (reference overlap
    semantics sfft/MultiEasySparsePacket.py:930-940)."""
    from sfft_jax.parallel import batch as batch_mod
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.scheduler import run_mesh_batched, STATUS_OK

    events = []
    arr = np.zeros((4, 4))
    mesh = make_data_mesh(2)

    def prep_fn(tid):
        events.append(("prep_start", tid, time.time()))
        time.sleep(0.5 if tid == 4 else 0.05)
        events.append(("prep_end", tid, time.time()))
        return {"tid": tid}

    def group_inputs(prep):
        return ("cfg0", arr, arr, arr, arr, True)

    def fake_batched(I, J, mI, mJ, cfg, m):
        events.append(("batch_start", I.shape[0], time.time()))
        time.sleep(0.05)
        events.append(("batch_end", I.shape[0], time.time()))
        B = I.shape[0]
        return (np.zeros((B, 3)), np.zeros((B, 4, 4)), np.zeros(B))

    def subtract_fn(tid, prep, precomputed=None):
        return tid

    monkeypatch.setattr(batch_mod, "batched_subtract", fake_batched)
    status, products = run_mesh_batched(
        5, prep_fn, subtract_fn, group_inputs,
        NUM_THREADS_4PREPROC=1, VERBOSE_LEVEL=0, mesh=mesh)
    assert all(s == STATUS_OK for s in status.values())
    t = {(k, i): tt for k, i, tt in events}
    # with 1 prep thread and a 2-device mesh, the first full group (tasks
    # 0+1) must hit the mesh BEFORE the slow prep of task 4 finishes
    assert ("batch_start", 2) in t
    assert t[("batch_start", 2)] < t[("prep_end", 4)]


def test_mesh_batch_pipelines_collect_behind_next_group(monkeypatch):
    """The mesh-batch dispatcher is a two-deep pipeline: group k+1's staged
    H2D + program dispatch must be ISSUED before group k's results are
    fetched, so on slow-H2D runtimes the next group's upload/compute rides
    under the current group's blocking D2H instead of serializing after it."""
    from sfft_jax.parallel import batch as batch_mod
    from sfft_jax.parallel import scheduler as sched_mod
    from sfft_jax.parallel.scheduler import run_mesh_batched, STATUS_OK
    from sfft_jax.parallel.batch import make_data_mesh

    events = []
    arr = np.zeros((4, 4))
    mesh = make_data_mesh(2)

    def prep_fn(tid):
        return {"tid": tid}

    def group_inputs(prep):
        return ("cfg0", arr, arr, arr, arr, True)

    def fake_stage(stacks, m):
        events.append(("stage", stacks[0].shape[0]))
        return stacks

    launches = [0]

    def fake_batched(I, J, mI, mJ, cfg, m):
        launches[0] += 1
        events.append(("launch", launches[0]))
        B = I.shape[0]
        return (np.zeros((B, 3)), np.zeros((B, 4, 4)), np.zeros(B))

    def subtract_fn(tid, prep, precomputed=None):
        events.append(("finish", tid))
        assert precomputed is not None
        return tid

    monkeypatch.setattr(sched_mod, "_stage_group_arrays", fake_stage)
    monkeypatch.setattr(batch_mod, "batched_subtract", fake_batched)
    status, products = run_mesh_batched(
        4, prep_fn, subtract_fn, group_inputs,
        NUM_THREADS_4PREPROC=4, VERBOSE_LEVEL=0, mesh=mesh)
    assert all(s == STATUS_OK for s in status.values())
    order = {e: i for i, e in enumerate(events) if e[0] != "stage"}
    # two groups of 2 were launched, and the SECOND launch was issued
    # before ANY task of the first group was collected/finished
    assert launches[0] == 2
    first_finish = min(i for e, i in order.items() if e[0] == "finish")
    assert order[("launch", 2)] < first_finish
    # every task got a precomputed (batched) result
    assert sorted(products[t]["result"] for t in range(4)) == [0, 1, 2, 3]


def test_mesp_mesh_batch(tmp_path, monkeypatch):
    """Homogeneous (shape, config) tasks are dispatched as one sharded array
    program over the device mesh."""
    from sfft_jax.io import fits
    from sfft_jax.api.easy_sparse import EasySparsePacket
    from sfft_jax.parallel import batch as batch_mod
    from sfft_jax.parallel import scheduler as sched_mod
    from sfft_jax.parallel.scheduler import MultiEasySparsePacket, STATUS_OK
    from tests.test_prep import synth_field

    rng = np.random.default_rng(21)
    ref, truth = synth_field(rng, N0=256, N1=256, nstars=120, fwhm=2.8, bg=0.0)
    sci, _ = synth_field(rng, N0=256, N1=256, nstars=0, fwhm=3.5, bg=0.0)
    yy, xx = np.meshgrid(np.arange(256), np.arange(256))
    sig = 3.5 / 2.355
    for x0, y0, f in truth:
        sci += 1.15 * f / (2 * np.pi * sig**2) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    hdr = fits.Header()
    hdr.add("GAIN", 1.0)
    hdr.add("ESATUR", 1.0e9)
    fits.write(str(tmp_path / "ref.fits"), ref.T, hdr)
    fits.write(str(tmp_path / "sci.fits"), sci.T, hdr)

    calls = []
    real_batched = batch_mod.batched_subtract

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real_batched(*args, **kw)

    monkeypatch.setattr(batch_mod, "batched_subtract", spy)

    ntask = 3
    refs = [str(tmp_path / "ref.fits")] * ntask
    scis = [str(tmp_path / "sci.fits")] * ntask
    diffs = [str(tmp_path / f"diff{t}.fits") for t in range(ntask)]
    mesp = MultiEasySparsePacket(refs, scis, FITS_DIFF_Queue=diffs,
                                 GKerHW_Queue=[3] * ntask)
    status, products = mesp.MESP(NUM_THREADS_4PREPROC=2, MESH_BATCH=True,
                                 VERBOSE_LEVEL=0)
    assert all(s == STATUS_OK for s in status.values())
    # one mesh dispatch, padded from 3 tasks to the 8-device mesh size
    assert calls == [(8, 256, 256)]
    # batched result matches the per-task path
    diff_b, _, sol_b, _, _ = products[0]["result"]
    diff_s, _, sol_s, _, _ = EasySparsePacket.ESP(
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        GKerHW=3, VERBOSE_LEVEL=0)
    np.testing.assert_allclose(sol_b, sol_s, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(diff_b, diff_s, rtol=1e-6, atol=1e-8)


def test_multihost_single_process(rng):
    """Multi-host survey machinery degenerates correctly to one process:
    no distributed init, global mesh = local mesh, process-local batch
    round-trips through global sharded arrays and matches the plain path."""
    from sfft_jax.parallel import multihost as mh
    from sfft_jax.parallel.batch import batched_subtract
    from tests.test_engine import make_pair, base_cfg

    assert mh.init_multihost() == 1  # no-op single process
    spec = mh.MultiHostSpec.from_env()
    assert spec.num_processes == 1

    # task assignment covers every task exactly once across fake processes
    for pc in (1, 3, 5):
        got = np.concatenate([mh.assign_tasks(11, p, pc) for p in range(pc)])
        np.testing.assert_array_equal(np.sort(got), np.arange(11))

    cfg = base_cfg(N0=32, N1=32, w=1)
    Is, Js = [], []
    for k in range(8):
        I, J = make_pair(rng, N0=32, N1=32)
        Is.append(I)
        Js.append(J)
    I = np.stack(Is)
    J = np.stack(Js)
    mesh = mh.global_data_mesh()
    sols, diffs, rms = mh.process_local_batch(I, J, I, J, cfg, mesh)
    sols_ref, diffs_ref, _ = batched_subtract(I, J, I, J, cfg)
    np.testing.assert_allclose(sols, np.asarray(sols_ref), rtol=1e-12)
    np.testing.assert_allclose(diffs, np.asarray(diffs_ref), rtol=1e-12)


def test_multihost_survey_driver(rng):
    """run_survey_multihost: single process, 11 tasks over 8 devices ->
    two collective batches with padding; every task gets a result."""
    from sfft_jax.parallel import multihost as mh
    from tests.test_engine import make_pair, base_cfg

    cfg = base_cfg(N0=32, N1=32, w=1)
    pairs = list(range(11))
    data = {}
    for t in pairs:
        I, J = make_pair(np.random.default_rng(t), N0=32, N1=32)
        data[t] = (I, J, I, J)

    results = mh.run_survey_multihost(pairs, lambda t: data[t], cfg)
    assert sorted(results) == pairs
    for t in pairs:
        sol, rms = results[t]
        assert sol.shape == (cfg.NEQ,)
        assert np.isfinite(rms)


def test_batched_subtract_exact_backend(rng):
    """Survey mesh batching works with the exact (f64-emulating) backends —
    the opt-in engine must vmap/shard cleanly."""
    import dataclasses

    from sfft_jax.parallel.batch import batched_subtract, make_data_mesh
    from tests.test_engine import base_cfg, make_pair

    cfg = dataclasses.replace(base_cfg(N0=32, N1=32, w=1),
                              greek_backend="exact", fdiff_backend="exact",
                              solver="exact")
    Is, Js = [], []
    for k in range(8):
        I, J = make_pair(rng, N0=32, N1=32)
        Is.append(I)
        Js.append(J)
    I = np.stack(Is)
    J = np.stack(Js)
    sols, diffs, rms = batched_subtract(I, J, I, J, cfg, make_data_mesh(8))
    assert sols.shape == (8, cfg.NEQ)
    # spot-check one pair against the plain fft/lu engine
    from sfft_jax.core.engine import ElementalSFFT
    cfg0 = base_cfg(N0=32, N1=32, w=1)
    sol0, diff0 = ElementalSFFT.ESS(Is[0], Js[0], cfg0, Subtract=True)
    sc = np.max(np.abs(np.asarray(sol0)))
    assert np.max(np.abs(np.asarray(sols[0]) - np.asarray(sol0))) / sc < 1e-6
    np.testing.assert_allclose(np.asarray(diffs[0]), np.asarray(diff0),
                               rtol=1e-5, atol=1e-6)


def test_multihost_two_real_processes(tmp_path):
    """REAL multi-process validation of the multi-host survey path: two
    OS processes, each with 2 virtual CPU devices, wired into one 4-device
    runtime via jax.distributed (env-spec path). Each process must return
    results ONLY for its own task slab, fetched from its addressable shards
    (remote shards are non-addressable in a real run — the failure mode
    single-process testing cannot see), and the solutions must match the
    single-process ground truth bit-for-bit-grade."""
    import socket
    import subprocess
    import sys
    import textwrap

    repo = pa.dirname(pa.dirname(pa.abspath(__file__)))
    worker = tmp_path / "mh_worker.py"
    worker.write_text(textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        from sfft_jax.parallel.multihost import run_survey_multihost

        sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
        from test_engine import make_pair, base_cfg

        def load_fn(t):
            I, J = make_pair(np.random.default_rng(t), N0=32, N1=32)
            return I, J, I, J

        cfg = base_cfg(N0=32, N1=32, w=1)
        res = run_survey_multihost(list(range(6)), load_fn, cfg)
        np.savez(sys.argv[2],
                 keys=np.array(sorted(res), int),
                 sols=np.stack([res[k][0] for k in sorted(res)]),
                 rms=np.array([res[k][1] for k in sorted(res)]))
        print("WORKER_OK", jax.process_index(), sorted(res), flush=True)
    """))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   SFFT_COORDINATOR_ADDRESS=f"localhost:{port}",
                   SFFT_NUM_PROCESSES="2", SFFT_PROCESS_ID=str(pid))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), repo,
             str(tmp_path / f"res{pid}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    from sfft_jax.core.engine import GeneralSFFT
    from tests.test_engine import make_pair, base_cfg

    cfg = base_cfg(N0=32, N1=32, w=1)
    r0 = np.load(tmp_path / "res0.npz")
    r1 = np.load(tmp_path / "res1.npz")
    np.testing.assert_array_equal(r0["keys"], [0, 1, 2])   # slab 0
    np.testing.assert_array_equal(r1["keys"], [3, 4, 5])   # slab 1
    for r in (r0, r1):
        for k, sol, rms in zip(r["keys"], r["sols"], r["rms"]):
            I, J = make_pair(np.random.default_rng(int(k)), N0=32, N1=32)
            sol_ref, diff_ref, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
            np.testing.assert_allclose(sol, np.asarray(sol_ref),
                                       rtol=1e-10, atol=1e-12)
            assert abs(rms - float(np.sqrt(np.mean(np.asarray(diff_ref) ** 2)))) < 1e-9


def test_scheduler_prefetch_overlaps_next_task():
    """The sub worker must issue task k+1's prefetch (async H2D stand-in)
    BEFORE task k's blocking subtract, and the subtract must receive the
    prefetched product. First task is never prefetched (nothing runs under
    it), and results/statuses are unaffected."""
    from sfft_jax.parallel.scheduler import MultiTaskScheduler, STATUS_OK

    events = []
    lock = __import__("threading").Lock()

    def prep_fn(tid):
        return {"tid": tid, "dev": False}

    def prefetch_fn(prep):
        with lock:
            events.append(("prefetch", prep["tid"]))
        return dict(prep, dev=True)

    def subtract_fn(tid, prep):
        with lock:
            events.append(("sub_start", tid, prep["dev"]))
        time.sleep(0.05)
        with lock:
            events.append(("sub_end", tid))
        return prep["dev"]

    sched = MultiTaskScheduler(
        4, prep_fn, subtract_fn, NUM_THREADS_4PREPROC=4,
        NUM_THREADS_4SUBTRACT=1, VERBOSE_LEVEL=0, prefetch_fn=prefetch_fn)
    # complete ALL preps first so the prefetch set is deterministic: with
    # preps racing the sub worker, a task claimed before any sibling reaches
    # PREP_OK is (correctly) never prefetched and the count assertion below
    # would flake (observed on the 1-core host under full-suite load)
    sched.run_prep_only()
    status, products = sched.run()
    assert all(s == STATUS_OK for s in status.values())
    # every non-first task was prefetched before its subtract started
    pf = {t for e, *r in events if e == "prefetch" for t in r}
    assert len(pf) == 3  # one task (the first claimed) is never prefetched
    for e in events:
        if e[0] == "sub_start" and e[1] in pf:
            assert e[2] is True, f"task {e[1]} ran on un-prefetched product"
    # the prefetch of some later task was issued before an earlier task's
    # subtract finished (overlap actually happened)
    first_end = next(i for i, e in enumerate(events) if e[0] == "sub_end")
    assert any(e[0] == "prefetch" for e in events[:first_end])
    # un-prefetched first task still subtracts fine (dev=False result)
    assert sorted(products[t]["result"] for t in range(4)) == [
        False, True, True, True]


def test_mecp_real_pipeline(tmp_path):
    """MultiEasyCrowdedPacket end-to-end with REAL crowded prep + subtract:
    two synthetic saturated fields through ECP_Prep (super-background,
    saturation masks) and ECP_Subtract on the per-task scheduler path —
    the crowded twin of the sparse MESP coverage (reference
    MultiEasyCrowdedPacket.py:259-717)."""
    from sfft_jax.io import fits
    from sfft_jax.parallel.scheduler import MultiEasyCrowdedPacket, STATUS_OK
    from tests.test_prep import synth_field

    refs, scis, diffs = [], [], []
    for t in range(2):
        rng = np.random.default_rng(40 + t)
        ref, _ = synth_field(rng, N0=200, N1=200, nstars=200, fwhm=3.0,
                             bg=500.0, satur=30000.0)
        sci = 1.1 * (ref - 500.0) + 520.0 + rng.normal(0, 2.0, ref.shape)
        sci = np.minimum(sci, 30000.0)
        hdr = fits.Header()
        hdr.add("GAIN", 1.0)
        hdr.add("SATURATE", 30000.0)
        fits.write(str(tmp_path / f"ref{t}.fits"), ref.T, hdr)
        fits.write(str(tmp_path / f"sci{t}.fits"), sci.T, hdr)
        refs.append(str(tmp_path / f"ref{t}.fits"))
        scis.append(str(tmp_path / f"sci{t}.fits"))
        diffs.append(str(tmp_path / f"diff{t}.fits"))

    mecp = MultiEasyCrowdedPacket(refs, scis, FITS_DIFF_Queue=diffs,
                                  ForceConv_Queue=["REF", "REF"],
                                  GKerHW_Queue=[3, 3])
    status, products = mecp.MECP(NUM_THREADS_4PREPROC=2,
                                 NUM_THREADS_4SUBTRACT=1, VERBOSE_LEVEL=0)
    assert all(s == STATUS_OK for s in status.values())
    for t in range(2):
        diff, hdr = fits.read(diffs[t])
        diff = diff.T
        ref, _ = fits.read(refs[t])
        sci, _ = fits.read(scis[t])
        resid = np.sqrt(np.nanmean(diff**2))
        raw = np.sqrt(np.nanmean((sci - ref) ** 2))
        assert resid < 0.3 * raw, f"task {t}: {resid} vs raw {raw}"


@pytest.mark.parametrize("half", [False, True])
def test_sharded_exact_fft2_pair_matches_local(half):
    """Hand-scheduled shard_map pencil decomposition of the exact pair-FFT
    (explicit four-lane all_to_all transposes) vs the local transform."""
    rng = np.random.default_rng(9)
    import jax.numpy as jnp
    from sfft_jax.core.exact_fft import exact_fft2_pair, pair_to_c128
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.sharded_fft import sharded_exact_fft2_pair

    mesh = make_data_mesh(8)
    F = rng.normal(100.0, 30.0, (128, 96))
    sp_sh = sharded_exact_fft2_pair(jnp.asarray(F), mesh, half=half)
    sp_lo = exact_fft2_pair(jnp.asarray(F), half=half)
    a = np.asarray(pair_to_c128(sp_sh))
    b = np.asarray(pair_to_c128(sp_lo))
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) < 1e-13 * np.max(np.abs(b))


def test_sharded_subtract_step_production_engines():
    """Row-sharded single-pair step for the PRODUCTION engine families
    (contract exact + pexact), not only the CPU-default fft/lu config."""
    import dataclasses

    rng = np.random.default_rng(11)
    from sfft_jax.core.engine import solve_and_subtract_fn
    from sfft_jax.parallel.batch import make_data_mesh
    from sfft_jax.parallel.sharded_fft import sharded_subtract_step
    from tests.test_engine import base_cfg, make_pair

    import jax

    mesh = make_data_mesh(8)
    I, J = make_pair(rng, N0=64, N1=64)
    base = base_cfg(N0=64, N1=64, w=1)
    for gb, fb, sv in [("exact", "exact", "exact"),
                       ("pexact", "pexact", "exact")]:
        cfg = dataclasses.replace(base, greek_backend=gb, fdiff_backend=fb,
                                  solver=sv)
        run = sharded_subtract_step(cfg, mesh)
        sol, diff = run(I, J, I, J)
        sol_ref, diff_ref = jax.jit(solve_and_subtract_fn(cfg))(I, J, I, J)
        dev = float(np.max(np.abs(np.asarray(diff) - np.asarray(diff_ref))))
        assert dev < 1e-7, (gb, dev)
