"""Phase timing + profiler integration.

Reference: wall-clock segment timers printed at VERBOSE_LEVEL 2 with labeled
phases a-k (sfft/sfftcore/SFFTSubtract.py:172-178, 416-425, 465-470). Here a
small context-manager based phase timer with the same reporting style, plus a
jax.profiler trace hook.

JAX dispatches asynchronously, so a phase that produced device arrays is
timed up to jax.block_until_ready on its result (sync).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


def sync(x):
    """Block until every array in the pytree x is computed; returns x."""
    import jax

    return jax.block_until_ready(x)


class PhaseTimer:
    """Collects labeled phase durations; prints the reference's report style."""

    def __init__(self, verbose_level: int = 2):
        self.verbose_level = verbose_level
        self.phases: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def phase(self, label: str, sync_result=None):
        t0 = time.time()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                sync(box["result"])
            elif sync_result is not None:
                sync(sync_result)
            dt = time.time() - t0
            if label not in self.phases:
                self._order.append(label)
                self.phases[label] = 0.0
            self.phases[label] += dt

    def report(self):
        if self.verbose_level >= 2:
            total = sum(self.phases.values())
            for i, label in enumerate(self._order):
                tag = chr(ord("a") + i)
                print(f"/////   {tag}   ///// {label:40s} ({self.phases[label]:.4f}s)")
            print(f"MeLOn CheckPoint: TOTAL [{total:.4f}s]")
        return dict(self.phases)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
