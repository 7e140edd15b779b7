"""Survey-mode multi-task scheduler (the MultiEasy* replacement).

Reference: MultiEasy_SparsePacket.MESP_Cupy / MultiEasy_CrowdedPacket
(sfft/MultiEasySparsePacket.py:391-948, sfft/MultiEasyCrowdedPacket.py):
a status dict {0 init, 32 prep-running, 1 prep-ok, -1 prep-fail,
64 sub-running, 2 ok, -2 fail}, N CPU preprocessing threads feeding one
subtraction thread per CUDA device, work-stealing under an RLock, per-task
timeouts, and per-device memory cleanup on failure.

Redesign, same externally observable semantics:
  * preprocessing stays in a thread pool (CPU/numpy work);
  * homogeneous tasks (same image shape + config) are batched and dispatched
    as sharded array programs over the device mesh
    (sfft_jax/parallel/batch.py) — XLA's collectives replace the per-device
    thread queue entirely;
  * heterogeneous tasks fall back to a per-device dispatch loop with the
    reference's status codes, timeouts and failure isolation.
"""

from __future__ import annotations

import threading
import time
import traceback
from functools import lru_cache, partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sfft_jax.utils.multiproc import TimeoutAfter, TimeoutError_

# status codes (reference MultiEasySparsePacket.py:396-416)
STATUS_INIT = 0
STATUS_PREP_RUNNING = 32
STATUS_PREP_OK = 1
STATUS_PREP_FAIL = -1
STATUS_SUB_RUNNING = 64
STATUS_OK = 2
STATUS_FAIL = -2


class MultiTaskScheduler:
    """Generic two-stage (preprocess -> subtract) task scheduler."""

    def __init__(
        self,
        num_tasks: int,
        prep_fn: Callable[[int], object],
        subtract_fn: Callable[[int, object], object],
        NUM_THREADS_4PREPROC: int = 4,
        NUM_THREADS_4SUBTRACT: int = 1,
        TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
        TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
        VERBOSE_LEVEL: int = 1,
        prefetch_fn: Optional[Callable[[object], object]] = None,
    ):
        self.num_tasks = num_tasks
        self.prep_fn = prep_fn
        self.subtract_fn = subtract_fn
        self.nprep = NUM_THREADS_4PREPROC
        self.nsub = NUM_THREADS_4SUBTRACT
        self.t_prep = TIMEOUT_4PREPROC_EACHTASK
        self.t_sub = TIMEOUT_4SUBTRACT_EACHTASK
        self.verbose = VERBOSE_LEVEL
        # prefetch_fn(prep) -> prep: issue the NEXT ready task's H2D transfers
        # (async jax.device_put) right before the current task's blocking
        # solve, so the upload of pair k+1 rides under pair k's compute
        # instead of serializing in front of it. One-task lookahead bounds
        # device residency to two tasks' inputs.
        self.prefetch_fn = prefetch_fn
        self.lock = threading.RLock()
        self.status: Dict[int, int] = {i: STATUS_INIT for i in range(num_tasks)}
        self.products: Dict[int, dict] = {i: {} for i in range(num_tasks)}

    # ------------------------------------------------------------------
    def _prep_worker(self):
        while True:
            with self.lock:
                todo = [i for i, s in self.status.items() if s == STATUS_INIT]
                if not todo:
                    return
                tid = todo[0]
                self.status[tid] = STATUS_PREP_RUNNING
            try:
                with TimeoutAfter(self.t_prep):
                    prep = self.prep_fn(tid)
                with self.lock:
                    self.products[tid]["prep"] = prep
                    self.status[tid] = STATUS_PREP_OK
            except (Exception, TimeoutError_):
                if self.verbose >= 1:
                    traceback.print_exc()
                with self.lock:
                    self.status[tid] = STATUS_PREP_FAIL

    def _sub_worker(self, device_index: int):
        while True:
            with self.lock:
                pending_prep = any(
                    s in (STATUS_INIT, STATUS_PREP_RUNNING)
                    for s in self.status.values()
                )
                ready = [i for i, s in self.status.items() if s == STATUS_PREP_OK]
                if not ready:
                    if not pending_prep:
                        return
                    tid = None
                else:
                    tid = ready[0]
                    self.status[tid] = STATUS_SUB_RUNNING
            if tid is None:
                time.sleep(0.01)  # reference: 10 ms nap while prep pending
                continue
            if self.prefetch_fn is not None:
                with self.lock:
                    nxt = next(
                        (i for i, s in self.status.items()
                         if s == STATUS_PREP_OK
                         and not self.products[i].get("prefetched")), None)
                    if nxt is not None:
                        self.products[nxt]["prefetched"] = True
                try:
                    if nxt is not None:
                        # async H2D issue; overlaps the blocking solve below
                        prefetched = self.prefetch_fn(self.products[nxt]["prep"])
                        with self.lock:
                            self.products[nxt]["prep"] = prefetched
                except Exception:
                    if self.verbose >= 1:
                        traceback.print_exc()
            try:
                with TimeoutAfter(self.t_sub):
                    result = self.subtract_fn(tid, self.products[tid]["prep"])
                with self.lock:
                    self.products[tid]["result"] = result
                    self.status[tid] = STATUS_OK
            except (Exception, TimeoutError_):
                if self.verbose >= 1:
                    traceback.print_exc()
                with self.lock:
                    self.status[tid] = STATUS_FAIL

    # ------------------------------------------------------------------
    def run(self) -> Tuple[Dict[int, int], Dict[int, dict]]:
        threads = [threading.Thread(target=self._prep_worker)
                   for _ in range(self.nprep)]
        threads += [threading.Thread(target=self._sub_worker, args=(d,))
                    for d in range(self.nsub)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ok = sum(1 for s in self.status.values() if s == STATUS_OK)
        if self.verbose >= 1:
            print(f"MeLOn CheckPoint: MULTI-TASK SUCCESS [{ok} / "
                  f"{self.num_tasks}] in [{time.time()-t0:.1f} s]!")
        return self.status, self.products

    def run_prep_only(self) -> None:
        """Run only the preprocessing pool (statuses end at PREP_OK/PREP_FAIL)
        — for callers that dispatch the device stage themselves."""
        threads = [threading.Thread(target=self._prep_worker)
                   for _ in range(self.nprep)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def run_mesh_batched(
    num_tasks: int,
    prep_fn: Callable[[int], dict],
    subtract_fn: Callable,
    group_inputs: Callable[[dict], tuple],
    NUM_THREADS_4PREPROC: int = 4,
    TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
    TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
    VERBOSE_LEVEL: int = 1,
    mesh=None,
    PACK_H2D: str = "off",
) -> Tuple[Dict[int, int], Dict[int, dict]]:
    """Survey dispatch with STREAMING homogeneous-group mesh batching.

    PACK_H2D: 'off' (default) ships the planes as they are; 'auto' ships
    FAST-mode groups as int16 + per-block scales — half the bytes of f32,
    dequantized inside the sharded jit (utils/pack.py; quantization two
    orders below fast's accuracy floor, never applied to contract/pexact
    configs).

    The prep thread pool and the mesh dispatcher run CONCURRENTLY: as prep
    products arrive they are grouped by their static SFFTConfig (which pins
    shape + kernel HW + bases), and the moment a group reaches the mesh size
    it is dispatched as ONE sharded array program over the device mesh
    (sfft_jax/parallel/batch.py) — so preprocessing of later tasks overlaps
    device subtraction of earlier ones, preserving the reference scheduler's
    overlap property (sfft/MultiEasySparsePacket.py:930-940) in the batched
    mode too. When the prep pool drains, remaining partial groups are padded
    and flushed. Singleton groups and tasks needing contamination propagation
    take the per-task path. `group_inputs` maps a prep product to
    (cfg, I, J, mI, mJ, batchable: bool); per-task post-processing still runs
    through `subtract_fn(tid, prep, precomputed)`.
    """
    from sfft_jax.parallel.batch import batched_subtract, make_data_mesh

    sched = MultiTaskScheduler(
        num_tasks, prep_fn, lambda tid, prep: None,
        NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
        NUM_THREADS_4SUBTRACT=0,
        TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
        VERBOSE_LEVEL=VERBOSE_LEVEL,
    )
    t0 = time.time()
    status, products = sched.status, sched.products
    prep_threads = [threading.Thread(target=sched._prep_worker)
                    for _ in range(max(1, NUM_THREADS_4PREPROC))]
    for t in prep_threads:
        t.start()

    if mesh is None:
        mesh = make_data_mesh()
    nd = mesh.devices.size

    pending: Dict[object, List[int]] = {}   # cfg -> ready, undispatched tids
    solo: List[int] = []
    claimed: set = set()

    def _poll_ready() -> None:
        with sched.lock:
            ready = [i for i, s in status.items()
                     if s == STATUS_PREP_OK and i not in claimed]
        for tid in ready:
            claimed.add(tid)
            try:
                cfg, _I, _J, _mI, _mJ, batchable = \
                    group_inputs(products[tid]["prep"])
            except Exception:
                if VERBOSE_LEVEL >= 1:
                    traceback.print_exc()
                status[tid] = STATUS_FAIL
                continue
            if batchable:
                pending.setdefault(cfg, []).append(tid)
            else:
                solo.append(tid)

    def _finish(tid: int, precomputed) -> None:
        status[tid] = STATUS_SUB_RUNNING
        try:
            with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK):
                result = subtract_fn(tid, products[tid]["prep"],
                                     precomputed=precomputed)
            products[tid]["result"] = result
            status[tid] = STATUS_OK
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
            status[tid] = STATUS_FAIL

    # two-deep group pipeline: group k+1's sharded H2D (stage) and program
    # dispatch (launch) are issued BEFORE group k's results are fetched
    # (collect), so the next group's upload and compute ride under the
    # current group's blocking D2H fetch instead of serializing behind it.
    # Residency is bounded to two groups' inputs + outputs.
    inflight: List[tuple] = []   # [(cfg, tids, pad, launched_outputs)]

    def _dispatch(cfg, tids: List[int]) -> None:
        try:
            stacks = []
            for key in range(4):
                arrs = [group_inputs(products[t]["prep"])[1 + key]
                        for t in tids]
                stacks.append(np.stack(arrs))
            # pad to a multiple of the mesh size by repeating the last pair
            pad = (-len(tids)) % nd
            if pad:
                stacks = [np.concatenate([s, np.repeat(s[-1:], pad, axis=0)])
                          for s in stacks]
            if PACK_H2D == "auto" and _pack_eligible(cfg):
                from sfft_jax.parallel.batch import _batched_packed_fn
                from sfft_jax.utils.pack import pack_stack_i16

                packed = []
                for s_ in stacks:
                    q, sc, n0, blk = pack_stack_i16(
                        np.ascontiguousarray(s_, np.float32))
                    packed.extend((q, sc))
                staged = _stage_group_arrays(packed, mesh)   # async H2D
                with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK * len(tids)):
                    out = _batched_packed_fn(cfg, mesh, n0, blk)(*staged)
            else:
                staged = _stage_group_arrays(stacks, mesh)   # async H2D
                with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK * len(tids)):
                    out = batched_subtract(*staged, cfg, mesh)
            inflight.append((cfg, tids, pad, out))
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
                print("MeLOn WARNING: mesh-batched dispatch failed; "
                      "falling back to per-task path!")
            for tid in tids:
                if status[tid] == STATUS_PREP_OK:
                    _finish(tid, None)

    def _collect_oldest() -> None:
        cfg, tids, pad, out = inflight.pop(0)
        try:
            with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK * len(tids)):
                sols = np.asarray(out[0])
                diffs = np.asarray(out[1])
            if VERBOSE_LEVEL >= 1:
                print(f"MeLOn CheckPoint: MESH-BATCHED [{len(tids)}] tasks "
                      f"(+{pad} pad) over [{nd}] devices for config "
                      f"{cfg.N0}x{cfg.N1} KerHW={cfg.w0}!")
            for k, tid in enumerate(tids):
                _finish(tid, (sols[k], diffs[k]))
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
                print("MeLOn WARNING: mesh-batched collect failed; "
                      "falling back to per-task path!")
            for tid in tids:
                if status[tid] == STATUS_PREP_OK:
                    _finish(tid, None)

    # streaming loop: dispatch full groups while preps are still running
    while True:
        _poll_ready()
        dispatched = False
        for cfg in list(pending):
            while len(pending[cfg]) >= nd:
                tids = pending[cfg][:nd]
                del pending[cfg][:nd]
                _dispatch(cfg, tids)
                dispatched = True
                while len(inflight) > 1:   # keep the pipeline two deep
                    _collect_oldest()
        if not any(t.is_alive() for t in prep_threads):
            break
        if not dispatched:
            time.sleep(0.01)  # reference: 10 ms nap while prep pending
    for t in prep_threads:
        t.join()

    # drain: flush remaining partial groups (padded) and singletons
    _poll_ready()
    for cfg, tids in pending.items():
        if len(tids) >= 2:
            _dispatch(cfg, tids)
        else:
            solo.extend(tids)
    while inflight:
        _collect_oldest()
    for tid in solo:
        _finish(tid, None)

    ok = sum(1 for s in status.values() if s == STATUS_OK)
    if VERBOSE_LEVEL >= 1:
        print(f"MeLOn CheckPoint: MULTI-TASK SUCCESS [{ok} / "
              f"{num_tasks}] in [{time.time()-t0:.1f} s]!")
    return status, products


def _pack_eligible(cfg) -> bool:
    """int16 H2D packing is invisible only inside FAST-mode accuracy floors
    (quantization ~1.5e-5 of block max vs fast's ~7e-3; utils/pack.py).
    Contract/pexact/exact-solver configs must never be packed."""
    return (getattr(cfg, "fdiff_backend", None) == "fft32"
            and getattr(cfg, "greek_backend", None) in ("peeled", "fft32")
            and getattr(cfg, "solver", None) != "exact")


@lru_cache(maxsize=16)
def _unpack_jit(n0: int, block: int):
    import jax

    from sfft_jax.utils.pack import unpack_i16

    return jax.jit(lambda q, s: unpack_i16(q, s, n0, block))


def _stage_group_arrays(stacks, mesh):
    """Async sharded H2D of one mesh-batch group's four input stacks: each
    (B, N0, N1) stack is device_put with the batch axis sharded over the
    mesh's 'data' axis — the same placement batched_subtract's jit constrains
    to, so the program consumes the buffers without any resharding.
    device_put returns immediately; the DMA overlaps whatever the host does
    next (collecting the previous group's results)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    return [jax.device_put(s, sh) for s in stacks]


def _prefetch_pair_planes(prep: dict, pack: bool = False) -> dict:
    """Issue async H2D for the four solve-input planes of an ESP/ECP prep
    product (device_put returns immediately; the DMA then overlaps the
    current task's blocking solve). The engine consumes jnp arrays
    transparently. Used only on the per-task path, which runs on the
    default device — the mesh-batch path np.stacks prep products on host
    and shards them itself.

    pack=True (PACK_H2D='auto') ships FAST-mode configs as int16 +
    per-block scales (half the f32 bytes, utils/pack.py) and dequantizes
    in a tiny on-device jit; the stored planes are ordinary device arrays
    either way."""
    import jax
    import jax.numpy as jnp

    pack = pack and _pack_eligible(prep.get("cfg"))
    if pack:
        from sfft_jax.utils.pack import pack_i16

    for k in ("PixA_I", "PixA_J", "PixA_mI", "PixA_mJ"):
        a = prep.get(k)
        if a is not None and isinstance(a, np.ndarray):
            if pack:
                pk = pack_i16(np.ascontiguousarray(a, np.float32))
                q = jax.device_put(pk.q)
                s = jax.device_put(pk.scales)
                prep[k] = _unpack_jit(pk.n0, pk.block)(q, s)
            else:
                prep[k] = jax.device_put(jnp.asarray(a))
    return prep


def _prep_group_inputs(prep: dict) -> tuple:
    """(cfg, I, J, mI, mJ, batchable) from an ESP_Prep/ECP_Prep product.
    Contamination-mask propagation needs an extra kernel pass per task
    (GeneralSFFT.GSS), so such tasks are not mesh-batchable."""
    return (
        prep["cfg"], prep["PixA_I"], prep["PixA_J"],
        prep["PixA_mI"], prep["PixA_mJ"], prep["ContamMask_I"] is None,
    )


class MultiEasySparsePacket:
    """Reference MultiEasy_SparsePacket.MESP equivalent."""

    def __init__(self, FITS_REF_Queue: Sequence[str],
                 FITS_SCI_Queue: Sequence[str],
                 FITS_DIFF_Queue: Optional[Sequence[Optional[str]]] = None,
                 FITS_Solution_Queue: Optional[Sequence[Optional[str]]] = None,
                 ForceConv_Queue: Optional[Sequence[str]] = None,
                 GKerHW_Queue: Optional[Sequence[Optional[int]]] = None,
                 **esp_kwargs):
        n = len(FITS_REF_Queue)
        self.FITS_REF_Queue = list(FITS_REF_Queue)
        self.FITS_SCI_Queue = list(FITS_SCI_Queue)
        self.FITS_DIFF_Queue = list(FITS_DIFF_Queue or [None] * n)
        self.FITS_Solution_Queue = list(FITS_Solution_Queue or [None] * n)
        self.ForceConv_Queue = list(ForceConv_Queue or ["AUTO"] * n)
        self.GKerHW_Queue = list(GKerHW_Queue or [None] * n)
        self.esp_kwargs = esp_kwargs
        self.n = n

    def MESP(self, NUM_THREADS_4PREPROC: int = 4,
             NUM_THREADS_4SUBTRACT: int = 1,
             TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
             TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
             MESH_BATCH: bool = False, mesh=None,
             PACK_H2D: str = "off",
             VERBOSE_LEVEL: int = 1):
        """MESH_BATCH=False: pipelined two-stage dispatch — CPU preprocessing
        threads overlap the device subtraction loop, reference semantics
        (sfft/MultiEasySparsePacket.py:930-940). MESH_BATCH=True: STREAMING
        mesh batching — homogeneous-config groups are dispatched as sharded
        array programs the moment they fill to mesh size, while later preps
        are still running (run_mesh_batched)."""
        from sfft_jax.api.easy_sparse import EasySparsePacket

        def prep_fn(tid):
            return EasySparsePacket.ESP_Prep(
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                ForceConv=self.ForceConv_Queue[tid],
                GKerHW=self.GKerHW_Queue[tid],
                VERBOSE_LEVEL=0, **self.esp_kwargs,
            )

        def subtract_fn(tid, prep, precomputed=None):
            return EasySparsePacket.ESP_Subtract(
                prep,
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                FITS_DIFF=self.FITS_DIFF_Queue[tid],
                FITS_Solution=self.FITS_Solution_Queue[tid],
                VERBOSE_LEVEL=0, precomputed=precomputed, **self.esp_kwargs,
            )

        if MESH_BATCH:
            return run_mesh_batched(
                self.n, prep_fn, subtract_fn, _prep_group_inputs,
                NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
                TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
                TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
                VERBOSE_LEVEL=VERBOSE_LEVEL, mesh=mesh, PACK_H2D=PACK_H2D,
            )
        sched = MultiTaskScheduler(
            self.n, prep_fn, subtract_fn,
            NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
            NUM_THREADS_4SUBTRACT=NUM_THREADS_4SUBTRACT,
            TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
            TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
            prefetch_fn=partial(_prefetch_pair_planes,
                               pack=PACK_H2D == "auto"),
        )
        return sched.run()


class MultiEasyCrowdedPacket:
    """Reference MultiEasy_CrowdedPacket.MECP equivalent."""

    def __init__(self, FITS_REF_Queue, FITS_SCI_Queue,
                 FITS_DIFF_Queue=None, FITS_Solution_Queue=None,
                 ForceConv_Queue=None, GKerHW_Queue=None, **ecp_kwargs):
        n = len(FITS_REF_Queue)
        self.FITS_REF_Queue = list(FITS_REF_Queue)
        self.FITS_SCI_Queue = list(FITS_SCI_Queue)
        self.FITS_DIFF_Queue = list(FITS_DIFF_Queue or [None] * n)
        self.FITS_Solution_Queue = list(FITS_Solution_Queue or [None] * n)
        self.ForceConv_Queue = list(ForceConv_Queue or ["AUTO"] * n)
        self.GKerHW_Queue = list(GKerHW_Queue or [None] * n)
        self.ecp_kwargs = ecp_kwargs
        self.n = n

    def MECP(self, NUM_THREADS_4PREPROC: int = 4,
             NUM_THREADS_4SUBTRACT: int = 1,
             TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
             TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
             MESH_BATCH: bool = False, mesh=None,
             PACK_H2D: str = "off",
             VERBOSE_LEVEL: int = 1):
        from sfft_jax.api.easy_crowded import EasyCrowdedPacket

        def prep_fn(tid):
            return EasyCrowdedPacket.ECP_Prep(
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                ForceConv=self.ForceConv_Queue[tid],
                GKerHW=self.GKerHW_Queue[tid],
                VERBOSE_LEVEL=0, **self.ecp_kwargs,
            )

        def subtract_fn(tid, prep, precomputed=None):
            return EasyCrowdedPacket.ECP_Subtract(
                prep,
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                FITS_DIFF=self.FITS_DIFF_Queue[tid],
                FITS_Solution=self.FITS_Solution_Queue[tid],
                VERBOSE_LEVEL=0, precomputed=precomputed, **self.ecp_kwargs,
            )

        if MESH_BATCH:
            return run_mesh_batched(
                self.n, prep_fn, subtract_fn, _prep_group_inputs,
                NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
                TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
                TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
                VERBOSE_LEVEL=VERBOSE_LEVEL, mesh=mesh, PACK_H2D=PACK_H2D,
            )
        sched = MultiTaskScheduler(
            self.n, prep_fn, subtract_fn,
            NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
            NUM_THREADS_4SUBTRACT=NUM_THREADS_4SUBTRACT,
            TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
            TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
            prefetch_fn=partial(_prefetch_pair_planes,
                               pack=PACK_H2D == "auto"),
        )
        return sched.run()
