"""Resident engine server: compile once, keep data on the card, serve
subtractions.

Why this exists (no reference counterpart): a survey that launches one
process per field pays JAX start-up, backend initialization and the compile
of every SFFTConfig's fused step in each process, and a JAX process reserves
most of the card's memory when it first uses it, so only one process at a
time can work on a card. The engine daemon is that one process: it owns the
card, compiles and caches the jitted steps per SFFTConfig, keeps their
constants resident, and serves solve+subtract requests over a unix-domain
socket. A new job's time-to-first-difference is then IPC + H2D + compute.

Split of responsibilities:
  * `EngineServer` / `python -m sfft_jax.serve [SOCKET]` — the daemon. Imports
    jax and enables x64.
  * `EngineClient` — stdlib + numpy; never initializes a device backend in
    the client process (arrays travel as numpy; all jax work happens inside
    the server), so the server stays the only process on the card.
  * `ensure_server()` — connect-or-spawn helper for pipelines.

Wire protocol: 8-byte big-endian length + pickle (protocol 5) per message,
one request/response pair at a time per connection. The socket is chmod 0600
and unix-domain, so only the owning user can connect — required, since
unpickling is code execution. Requests:

  {"op": "ping"}                       -> {"ok", "platform", "pid"}
  {"op": "warm", "config": SFFTConfig} -> {"ok", "seconds"}   (compile+dispatch)
  {"op": "subtract", "config": cfg, "I":, "J":, "mI":, "mJ":,
   "solution": optional, "contam_mask": optional, "diff_dtype": optional}
      -> {"ok", "solution", "diff", "contam", "seconds"}
  {"op": "shutdown"}                   -> {"ok"}   (server exits)

`subtract` semantics mirror GeneralSFFT.GSS (solve on the masked pair, apply
to the unmasked; reference sfft/sfftcore/SFFTSubtract.py:839-923): omit
mI/mJ for the masked==unmasked fused path; pass `solution` to skip the solve
and only apply (the reference's SFFTSolution resume path,
sfft/sfftcore/SFFTSubtract.py:189-193).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

import numpy as np

DEFAULT_SOCKET = os.path.join(tempfile.gettempdir(), "sfft_engine.sock")
_LEN = struct.Struct(">Q")
_MAX_MSG = 1 << 34  # 16 GB frame cap: corrupt-length guard, not a real limit


# ---------------------------------------------------------------- framing
def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None  # peer closed
        got += r
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_MSG:
        raise ValueError(f"frame length {n} exceeds cap {_MAX_MSG}")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ConnectionError("peer closed mid-frame")
    return pickle.loads(payload)


# ---------------------------------------------------------------- server
class EngineServer:
    """Single-card resident engine. Thread-per-connection accept loop with
    one compute lock (the card serializes work anyway); `ping` answers
    without taking the lock, so liveness checks never block behind a 4K
    solve."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        self.socket_path = socket_path
        self._compute_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._platform: Optional[str] = None

    # -- boot ------------------------------------------------------------
    def _boot_backend(self) -> None:
        import jax

        # an explicit platform override through jax.config (tests run the
        # server on the CPU this way)
        plat = os.environ.get("SFFT_SERVE_PLATFORM")
        if plat:
            jax.config.update("jax_platforms", plat)
        jax.config.update("jax_enable_x64", True)
        self._platform = jax.default_backend()

    # -- request handlers --------------------------------------------------
    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True,
                "platform": self._platform,
                "pid": os.getpid(),
            }
        if op == "shutdown":
            self._shutdown.set()
            return {"ok": True}
        if op == "warm":
            return self._op_warm(req)
        if op == "subtract":
            return self._op_subtract(req)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_warm(self, req: dict) -> dict:
        import jax

        from sfft_jax.core.engine import _jitted_solve_and_subtract_same

        cfg = req["config"]
        cfg.validate()
        t0 = time.time()
        with self._compute_lock:
            step = _jitted_solve_and_subtract_same(cfg)
            z = np.zeros((cfg.N0, cfg.N1), np.dtype(cfg.dtype))
            jax.block_until_ready(step(z, z))
        return {"ok": True, "seconds": time.time() - t0}

    def _op_subtract(self, req: dict) -> dict:
        from sfft_jax.core.engine import ElementalSFFT, GeneralSFFT

        cfg = req["config"]
        cfg.validate()
        I = np.asarray(req["I"])
        J = np.asarray(req["J"])
        mI = req.get("mI")
        mJ = req.get("mJ")
        if (mI is None) != (mJ is None):
            return {"ok": False,
                    "error": "provide both mI and mJ, or neither"}
        solution = req.get("solution")
        contam = req.get("contam_mask")
        diff_dtype = req.get("diff_dtype")  # None => cfg dtype

        t0 = time.time()
        with self._compute_lock:
            if solution is not None:
                # apply-only resume path (reference SFFTSolution argument)
                sol, diff = ElementalSFFT.ESS(
                    I, J, cfg, SFFTSolution=np.asarray(solution),
                    Subtract=True)
                contam_out = None
            elif mI is None:
                sol, diff, contam_out = GeneralSFFT.GSS(
                    I, J, I, J, cfg, ContamMask_I=contam)
            else:
                sol, diff, contam_out = GeneralSFFT.GSS(
                    I, J, np.asarray(mI), np.asarray(mJ), cfg,
                    ContamMask_I=contam)
            sol_np = np.asarray(sol)
            if diff_dtype is not None:
                import jax.numpy as jnp

                diff = diff.astype(jnp.dtype(diff_dtype))
            diff_np = np.asarray(diff)
            contam_np = None if contam_out is None else np.asarray(contam_out)
        return {
            "ok": True,
            "solution": sol_np,
            "diff": diff_np,
            "contam": contam_np,
            "seconds": time.time() - t0,
        }

    # -- connection loop ---------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    req = _recv_msg(conn)
                except (ConnectionError, ValueError, OSError):
                    break
                if req is None:
                    break
                try:
                    resp = self._handle(req)
                except Exception as exc:  # noqa: BLE001 - shipped to client
                    resp = {
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                        "traceback": traceback.format_exc(),
                    }
                try:
                    _send_msg(conn, resp)
                except OSError:
                    break
                if self._shutdown.is_set():
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        self._boot_backend()
        path = self.socket_path
        # refuse to clobber a LIVE server; replace only a stale socket file
        if os.path.exists(path):
            if _ping_path(path, timeout=2.0) is not None:
                raise RuntimeError(f"engine server already live on {path}")
            os.unlink(path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(path)
            os.chmod(path, 0o600)  # unpickling is code execution: owner-only
            srv.listen(8)
            srv.settimeout(0.5)  # poll the shutdown flag
            while not self._shutdown.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name="sfft-serve-conn", daemon=True).start()
        finally:
            srv.close()
            try:
                os.unlink(path)
            except OSError:
                pass


# ---------------------------------------------------------------- client
def _ping_path(path: str, timeout: float = 5.0) -> Optional[dict]:
    """One-shot ping; None if the socket is absent/dead/not a server."""
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(path)
        try:
            _send_msg(s, {"op": "ping"})
            resp = _recv_msg(s)
        finally:
            s.close()
        return resp if isinstance(resp, dict) and resp.get("ok") else None
    except (OSError, pickle.UnpicklingError, EOFError):
        return None


class EngineClient:
    """Client handle. Stdlib + numpy — using it never initializes a jax
    backend in the client process, so the server stays the card's only
    process."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout: Optional[float] = None):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._lock = threading.Lock()

    # context manager
    def __enter__(self) -> "EngineClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _rpc(self, req: dict) -> dict:
        with self._lock:
            _send_msg(self._sock, req)
            resp = _recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        return resp

    def ping(self) -> dict:
        return self._rpc({"op": "ping"})

    def warm(self, cfg) -> float:
        """Compile + first-dispatch the fused step for `cfg`; returns server
        wall seconds. Call ahead of time so `subtract` is steady-state."""
        resp = self._rpc({"op": "warm", "config": cfg})
        _raise_on_error(resp)
        return resp["seconds"]

    def subtract(self, I, J, cfg, mI=None, mJ=None, solution=None,
                 contam_mask=None, diff_dtype=None):
        """GeneralSFFT.GSS over the wire. Returns (solution, diff, contam).
        Omit mI/mJ for masked==unmasked (fused single-pass program); pass
        `solution` to skip the solve and only apply; `diff_dtype='float32'`
        halves the D2H + wire bytes of the difference image."""
        resp = self._rpc({
            "op": "subtract",
            "config": cfg,
            "I": np.ascontiguousarray(I),
            "J": np.ascontiguousarray(J),
            "mI": None if mI is None else np.ascontiguousarray(mI),
            "mJ": None if mJ is None else np.ascontiguousarray(mJ),
            "solution": None if solution is None else np.asarray(solution),
            "contam_mask": None if contam_mask is None
            else np.ascontiguousarray(contam_mask),
            "diff_dtype": diff_dtype,
        })
        _raise_on_error(resp)
        return resp["solution"], resp["diff"], resp["contam"]

    def shutdown(self) -> None:
        try:
            self._rpc({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass  # server may exit before the response lands


class EngineServerError(RuntimeError):
    """Server-side failure, message + remote traceback attached."""

    def __init__(self, message: str, remote_traceback: Optional[str] = None):
        super().__init__(message)
        self.remote_traceback = remote_traceback


def _raise_on_error(resp: dict) -> None:
    if not resp.get("ok"):
        raise EngineServerError(
            resp.get("error", "engine server error"),
            resp.get("traceback"))


def ensure_server(socket_path: str = DEFAULT_SOCKET,
                  spawn_timeout: float = 120.0,
                  env: Optional[dict] = None) -> dict:
    """Connect to a live server at `socket_path`, or spawn one (detached
    daemon subprocess) and wait for it to answer ping. Returns the ping
    response. The spawned server keeps running after the caller exits — that
    is the point: the NEXT job reuses its compiled steps.

    The server must be the only process that opens the card: JAX reserves
    most of the card's memory in the first process that uses it, so a caller
    that has itself put work on the card leaves the server none. Callers
    talk to the server through EngineClient and stay off JAX's device
    backend."""
    resp = _ping_path(socket_path)
    if resp is not None:
        return resp
    proc_env = dict(os.environ if env is None else env)
    # make the package importable in the child regardless of its cwd
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prev = proc_env.get("PYTHONPATH", "")
    if pkg_root not in prev.split(os.pathsep):
        proc_env["PYTHONPATH"] = (
            pkg_root + (os.pathsep + prev if prev else ""))
    subprocess.Popen(
        [sys.executable, "-m", "sfft_jax.serve", socket_path],
        env=proc_env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,  # survive the parent's exit
    )
    deadline = time.time() + spawn_timeout
    while time.time() < deadline:
        resp = _ping_path(socket_path, timeout=2.0)
        if resp is not None:
            return resp
        time.sleep(0.25)
    raise TimeoutError(
        f"engine server did not come up on {socket_path} "
        f"within {spawn_timeout:.0f}s")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    path = args[0] if args else DEFAULT_SOCKET
    print(f"sfft_jax engine server on {path} (pid {os.getpid()})", flush=True)
    EngineServer(path).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
