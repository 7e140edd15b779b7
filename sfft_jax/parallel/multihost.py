"""Multi-host survey mode: one JAX process per host, a global device mesh.

The reference is strictly single-host (its multi-GPU scheduler pins one Python
thread per local CUDA device, sfft/MultiEasySparsePacket.py:391-948, zero
inter-GPU communication). Scaling the survey workload beyond one host is
the genuinely distributed extension: every host runs this same program,
`jax.distributed.initialize` wires the processes into one runtime, and a
global 1-D 'data' mesh over ALL devices (local + remote) carries the batch.
Each host contributes its process-local image pairs; XLA moves nothing across
hosts except the tiny QA summaries (per-pair diff RMS), because pairs are
sharded so every pair lives wholly on one device.

Single-process use (the common case, and the only one testable in this image)
needs no initialization at all: `init_multihost()` is a no-op when it cannot
see a multi-process launch environment, and `process_local_batch` degenerates
to the plain `parallel.batch` path on the local mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sfft_jax.config import SFFTConfig
from sfft_jax.parallel.batch import _batched_fn


@dataclass(frozen=True)
class MultiHostSpec:
    """Launch description for one process of a multi-host survey run.

    With `num_processes == 1` (default) everything is local and
    `jax.distributed.initialize` is never called.
    """

    coordinator_address: Optional[str] = None   # "host0:port" of process 0
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "MultiHostSpec":
        """Build from the launch environment (a no-op single-process
        spec when the variables are absent)."""
        addr = os.environ.get("SFFT_COORDINATOR_ADDRESS")
        if addr is None:
            return cls()
        return cls(
            coordinator_address=addr,
            num_processes=int(os.environ.get("SFFT_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("SFFT_PROCESS_ID", "0")),
        )


def init_multihost(spec: Optional[MultiHostSpec] = None) -> int:
    """Initialize the distributed runtime if (and only if) the spec describes
    a multi-process launch. Returns the number of participating processes.

    With a coordinator address the processes are wired explicitly
    (`host:port`, num_processes, process_id). Without one,
    `jax.distributed.initialize()` must infer the cluster from a launcher it
    recognizes (e.g. SLURM or Open MPI); on a machine that no launcher
    describes it fails, so give the address there.
    """
    spec = spec or MultiHostSpec.from_env()
    if spec.num_processes <= 1:
        return 1
    if spec.coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=spec.coordinator_address,
            num_processes=spec.num_processes,
            process_id=spec.process_id,
        )
    return jax.process_count()


def global_data_mesh() -> Mesh:
    """1-D 'data' mesh over ALL devices in the (possibly multi-process)
    runtime. Every process constructs the identical mesh."""
    return Mesh(np.array(jax.devices()), axis_names=("data",))


def assign_tasks(n_tasks: int, process_id: Optional[int] = None,
                 process_count: Optional[int] = None) -> np.ndarray:
    """Indices of the tasks this process must load from disk (block
    round-robin: contiguous slabs, so each host reads a contiguous shard of
    the task list — friendlier to shared-filesystem readahead than striding).
    """
    pid = jax.process_index() if process_id is None else process_id
    pc = jax.process_count() if process_count is None else process_count
    bounds = np.linspace(0, n_tasks, pc + 1).astype(int)
    return np.arange(bounds[pid], bounds[pid + 1])


def process_local_batch(
    local_I: np.ndarray, local_J: np.ndarray,
    local_mI: np.ndarray, local_mJ: np.ndarray,
    cfg: SFFTConfig, mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run one globally-sharded batch where THIS process contributes the
    given stack of pairs (B_local, N0, N1) and receives back only its own
    pairs' results.

    Every process must call this collectively with the same cfg and the same
    per-process batch size B_local = global_B / process_count; B_local must be
    a multiple of the local device count so each pair lands wholly on one
    device. Returns (solutions, diffs, rms) for the local pairs as host
    numpy arrays.
    """
    mesh = mesh or global_data_mesh()
    sharding = NamedSharding(mesh, P("data"))

    def to_global(x):
        return jax.make_array_from_process_local_data(sharding, x)

    I = to_global(local_I)
    J = to_global(local_J)
    mI = to_global(local_mI)
    mJ = to_global(local_mJ)
    run = _batched_fn(cfg, mesh)
    sols, diffs, rms = run(I, J, mI, mJ)

    def to_local(garr):
        shards = sorted(garr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    # rms is sharded over the data mesh exactly like sols/diffs (one scalar
    # per pair, living on that pair's device) — in a real multi-process run
    # the remote shards are non-addressable, so fetch only the local ones.
    return to_local(sols), to_local(diffs), to_local(rms)


def run_survey_multihost(
    pairs: Sequence, load_fn, cfg: SFFTConfig,
    spec: Optional[MultiHostSpec] = None,
) -> dict:
    """End-to-end multi-host survey driver (design entry point).

    pairs: the GLOBAL task list (e.g. filename tuples) — identical on every
    process. load_fn(task) -> (I, J, mI, mJ) numpy arrays. Each process loads
    only its `assign_tasks` slab, pads the final partial batch by repeating
    its last task, and streams batches through `process_local_batch`.
    Returns {global_index: (solution, diff_rms)} for the LOCAL tasks.
    """
    init_multihost(spec)
    mesh = global_data_mesh()
    n_local_dev = jax.local_device_count()
    mine = assign_tasks(len(pairs))
    # all processes must execute the same number of collective batches
    n_batches = int(np.ceil(max(
        len(assign_tasks(len(pairs), p, jax.process_count()))
        for p in range(jax.process_count())) / n_local_dev))
    results = {}
    for b in range(n_batches):
        sel = mine[b * n_local_dev : (b + 1) * n_local_dev]
        pad = n_local_dev - len(sel)
        idxs = list(sel) + [mine[-1] if len(mine) else 0] * pad
        loaded = [load_fn(pairs[i]) for i in idxs]
        stacks = [np.stack([t[k] for t in loaded]) for k in range(4)]
        sols, diffs, rms = process_local_batch(*stacks, cfg, mesh)
        for j, i in enumerate(sel):
            results[int(i)] = (sols[j], float(np.sqrt(np.mean(diffs[j] ** 2))))
    return results
