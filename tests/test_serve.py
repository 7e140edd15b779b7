"""Resident engine server (sfft_jax/serve.py): spawn a REAL server
subprocess on CPU, drive it through the stdlib+numpy client, and check the
results match the in-process engine. This is the component that keeps the
compiled steps and the card across survey jobs (one process on the card, not
one per job); no reference counterpart — the reference's cold start is
seconds of nvcc (sfft/sfftcore/SFFTConfigure.py:106-809)."""

import os
import sys
import time

import numpy as np
import pytest

from sfft_jax.serve import (
    EngineClient,
    EngineServerError,
    _ping_path,
    ensure_server,
)
from tests.test_engine import base_cfg, make_pair


@pytest.fixture(scope="module")
def server_socket(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "engine.sock")
    env = dict(os.environ, SFFT_SERVE_PLATFORM="cpu")
    # a lean single-device CPU server is all these tests need
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    resp = ensure_server(path, spawn_timeout=180.0, env=env)
    assert resp["ok"]
    yield path
    with EngineClient(path) as c:
        c.shutdown()
    deadline = time.time() + 30
    while os.path.exists(path) and time.time() < deadline:
        time.sleep(0.1)
    assert not os.path.exists(path), "server did not unlink its socket"


def test_subtract_matches_inprocess(server_socket, rng):
    from sfft_jax.core.engine import GeneralSFFT

    I, J = make_pair(rng, N0=64, N1=56)
    cfg = base_cfg(N0=64, N1=56, w=2)
    with EngineClient(server_socket) as c:
        sol, diff, contam = c.subtract(I, J, cfg)
    assert contam is None
    sol_ref, diff_ref, _ = GeneralSFFT.GSS(I, J, I, J, cfg)
    np.testing.assert_allclose(sol, np.asarray(sol_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(diff, np.asarray(diff_ref), rtol=1e-12, atol=1e-10)


def test_masked_pair_and_apply_only(server_socket, rng):
    from sfft_jax.core.engine import ElementalSFFT, GeneralSFFT

    I, J = make_pair(rng, N0=48, N1=48)
    mI, mJ = I.copy(), J.copy()
    mI[10:16, 20:26] = 0.0
    mJ[10:16, 20:26] = 0.0
    cfg = base_cfg(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        sol, diff, _ = c.subtract(I, J, cfg, mI=mI, mJ=mJ)
        # resume path: server applies a provided solution, no solve
        sol2, diff2, _ = c.subtract(I, J, cfg, solution=sol)
    sol_ref, diff_ref, _ = GeneralSFFT.GSS(I, J, mI, mJ, cfg)
    np.testing.assert_allclose(sol, np.asarray(sol_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(diff, np.asarray(diff_ref), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(sol2, sol, rtol=0, atol=0)
    _, diff_apply = ElementalSFFT.ESS(I, J, cfg, SFFTSolution=sol, Subtract=True)
    np.testing.assert_allclose(diff2, np.asarray(diff_apply), rtol=1e-12, atol=1e-10)


def test_mismatched_mask_args_rejected(server_socket, rng):
    I, J = make_pair(rng, N0=48, N1=48)
    cfg = base_cfg(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        with pytest.raises(EngineServerError, match="both mI and mJ"):
            c.subtract(I, J, cfg, mI=I)


def test_diff_dtype_downcast(server_socket, rng):
    I, J = make_pair(rng, N0=48, N1=48)
    cfg = base_cfg(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        _sol, diff, _ = c.subtract(I, J, cfg, diff_dtype="float32")
    assert diff.dtype == np.float32


def test_error_propagates_and_server_survives(server_socket, rng):
    I, J = make_pair(rng, N0=48, N1=48)
    cfg = base_cfg(N0=32, N1=32, w=1)  # wrong shape for these images
    with EngineClient(server_socket) as c:
        with pytest.raises(EngineServerError):
            c.subtract(I, J, cfg)
        # the failure is per-request: the same connection keeps working
        pong = c.ping()
    assert pong["ok"] and pong["platform"] == "cpu"


def test_warm_precompiles(server_socket):
    cfg = base_cfg(N0=40, N1=40, w=1)
    with EngineClient(server_socket) as c:
        first = c.warm(cfg)
        second = c.warm(cfg)
    assert first >= 0.0
    # second warm hits the server's jit cache: strictly cheaper than the
    # compile-bearing first call (wide margin to avoid timing flake)
    assert second < max(0.5, 0.5 * first)


def test_ensure_server_reuses_live_server(server_socket):
    pid0 = _ping_path(server_socket)["pid"]
    resp = ensure_server(server_socket)  # must NOT spawn a second daemon
    assert resp["pid"] == pid0


def test_client_process_never_touches_jax_backend(server_socket, tmp_path, rng):
    """A REAL client process performs a subtraction with jax backend
    initialization forcibly broken — proving the client path stays off the
    device backend entirely, so the server stays the card's only process."""
    import subprocess
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    I, J = make_pair(rng, N0=48, N1=48)
    np.savez(tmp_path / "pair.npz", I=I, J=J)
    script = tmp_path / "client.py"
    script.write_text(textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import jax
        # any backend initialization in THIS process must explode
        def _boom(*a, **k):
            raise AssertionError("client touched the jax backend")
        jax.config.update("jax_platforms", "nonexistent-platform")
        jax._src.xla_bridge.backends = _boom
        from sfft_jax.config import SFFTConfig, BasisSpec
        from sfft_jax.serve import EngineClient
        d = np.load(sys.argv[3])
        cfg = SFFTConfig(N0=48, N1=48, w0=1, w1=1,
                         kernel_basis=BasisSpec("polynomial", 2),
                         bg_basis=BasisSpec("polynomial", 2))
        with EngineClient(sys.argv[2]) as c:
            sol, diff, _ = c.subtract(d["I"], d["J"], cfg)
        assert sol.size == cfg.NEQ, sol.shape
        assert diff.shape == (48, 48)
        print("CLIENT_OK", flush=True)
    """))
    out = subprocess.run(
        [sys.executable, str(script), repo, server_socket,
         str(tmp_path / "pair.npz")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CLIENT_OK" in out.stdout
