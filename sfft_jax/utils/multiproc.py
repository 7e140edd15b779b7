"""Process/thread pool and timeout kits.

Reference: Multi_Proc.MP (sfft/utils/meta/MultiProc.py:9-58) — chunked
multiprocessing/threading map returning {taskid: result} — and TimeoutAfter
(sfft/utils/meta/TimeoutKit.py:7-57) — a context manager that raises in the
calling thread when the wall clock expires.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import threading
from typing import Callable, Dict, Optional, Sequence


class MultiProc:
    @staticmethod
    def MP(taskid_lst: Sequence, func: Callable, nproc: int = 8,
           mode: str = "threading") -> Dict:
        """Run func(taskid) for every task id; returns {taskid: result}.

        mode 'mp' uses a forked process pool (pickleable func required);
        its workers must not touch JAX: a fork after the parent initialized
        the CUDA backend leaves the children a broken copy of it, and the
        card's memory belongs to the parent anyway. 'threading' uses threads
        (fine for numpy/jax work that releases the GIL).
        """
        taskid_lst = list(taskid_lst)
        if mode == "mp":
            with mp.Pool(processes=min(nproc, max(len(taskid_lst), 1))) as pool:
                results = pool.map(func, taskid_lst)
            return dict(zip(taskid_lst, results))

        out: Dict = {}
        lock = threading.Lock()
        idx = {"next": 0}

        def worker():
            while True:
                with lock:
                    k = idx["next"]
                    if k >= len(taskid_lst):
                        return
                    idx["next"] = k + 1
                tid = taskid_lst[k]
                res = func(tid)
                with lock:
                    out[tid] = res

        threads = [threading.Thread(target=worker)
                   for _ in range(min(nproc, max(len(taskid_lst), 1)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out


class TimeoutError_(Exception):
    pass


class TimeoutAfter:
    """Context manager: raise TimeoutError_ in the calling thread if the block
    runs longer than `timeout` seconds (reference TimeoutKit: async-exception
    injection via PyThreadState_SetAsyncExc)."""

    def __init__(self, timeout: Optional[float] = None):
        self.timeout = timeout
        self._timer = None
        self._tid = None

    def _interrupt(self):
        if self._tid is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(self._tid), ctypes.py_object(TimeoutError_)
            )

    def __enter__(self):
        if self.timeout is not None:
            self._tid = threading.get_ident()
            self._timer = threading.Timer(self.timeout, self._interrupt)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._timer is not None:
            self._timer.cancel()
        return False
