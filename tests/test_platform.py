"""Backend-independent configuration, the GPU default path's pieces, and the
checks chip_smoke.py makes on the card, exercised on the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sfft_jax  # noqa: F401  (enables x64)
from sfft_jax.config import MODES, make_config

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("builder", ["make_config", "make_bspline_config"])
def test_default_configs_resolve_native_f64(monkeypatch, backend, builder):
    """Both config builders resolve the native f64 triple fft/fft/lu
    whatever backend JAX reports."""
    from sfft_jax.api.bspline import make_bspline_config

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if builder == "make_config":
        cfg = make_config(64, 64, 3)
    else:
        cfg = make_bspline_config(64, 64, 3, KerSpType="B-Spline",
                                  KerIntKnotX=[32.5], KerIntKnotY=[32.5])
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == \
        ("fft", "fft", "lu")


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_resolution_every_backend(monkeypatch, backend, mode):
    """mode= fills the knobs from config.MODES on every backend; explicit
    knobs win over the mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = make_config(48, 40, 2, mode=mode)
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == \
        tuple(MODES[mode][k] for k in
              ("greek_backend", "fdiff_backend", "solver"))
    assert make_config(48, 40, 2, mode=mode, solver="cho").solver == "cho"


@pytest.mark.parametrize("S,N0,N1", [(3, 300, 257), (16, 512, 130),
                                     (20, 256, 129)])
def test_exact_skinny_matmul_f64(S, N0, N1):
    """The peeled engine's moment product P0 @ G is a plain f64 GEMM, exact
    to f64 rounding even with a large dynamic range in the weights."""
    from sfft_jax.core.peel import _exact_skinny_matmul

    rng = np.random.default_rng(5)
    W = rng.normal(0, 1, (S, N0)) * np.logspace(0, 6, N0)[None, :]
    G = rng.normal(0, 1, (N0, N1)) + 1e4
    out = np.asarray(jax.jit(_exact_skinny_matmul)(jnp.asarray(W),
                                                   jnp.asarray(G)))
    ref = W @ G
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-13


@pytest.mark.parametrize("backend,method", [("cpu", "irfft"),
                                            ("gpu", "matmul")])
def test_corr_window_auto_picks_recorded_winner(monkeypatch, backend,
                                                method):
    """method='auto' takes the partial-iDFT matmul route on the GPU (faster
    there at 4096^2, PERF.md) and the full irfft on the CPU."""
    from sfft_jax.core import greek

    used = []
    real = greek._partial_idft_mats

    def spy(*a, **k):
        used.append("matmul")
        return real(*a, **k)

    monkeypatch.setattr(greek, "_partial_idft_mats", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    spec = jnp.fft.rfft2(jnp.asarray(
        np.random.default_rng(1).normal(size=(2, 32, 24))))
    greek.corr_window_fft(spec, spec, 32, 24, 2, 2)
    assert (used[:1] or ["irfft"])[0] == method


@pytest.mark.parametrize("symmetric", [False, True])
def test_corr_window_methods_agree(symmetric):
    from sfft_jax.core.greek import corr_window_fft

    rng = np.random.default_rng(2)
    A = jnp.fft.rfft2(jnp.asarray(rng.normal(size=(3, 40, 36))))
    B = A if symmetric else jnp.fft.rfft2(jnp.asarray(
        rng.normal(size=(2, 40, 36))))
    m = corr_window_fft(A, B, 40, 36, 3, 4, method="matmul",
                        symmetric=symmetric)
    i = corr_window_fft(A, B, 40, 36, 3, 4, method="irfft")
    assert m.shape == i.shape
    np.testing.assert_allclose(np.asarray(m), np.asarray(i),
                               atol=1e-12 * float(jnp.max(jnp.abs(i))))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and the
    package sets no directory of its own."""
    from sfft_jax.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Without the variable the cache lives at one fixed path inside the
    checkout, the same on every call."""
    from sfft_jax.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = cache.setup_compile_cache()
        assert first == cache.setup_compile_cache()
        assert first == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_profiling_sync_blocks_every_leaf(monkeypatch):
    """profiling.sync hands the WHOLE pytree to jax.block_until_ready."""
    from sfft_jax.utils import profiling

    seen = []
    real = jax.block_until_ready

    def spy(x):
        seen.append(len(jax.tree_util.tree_leaves(x)))
        return real(x)

    monkeypatch.setattr(jax, "block_until_ready", spy)
    tree = {"a": jnp.ones(3), "b": [jnp.zeros(2), jnp.arange(4)]}
    assert profiling.sync(tree) is not None
    assert seen == [3]


def test_phase_timer_smoke(capsys):
    """utils/profiling.PhaseTimer: labeled a-k style phase report (the
    reference's VERBOSE_LEVEL=2 segment timers, sfft/sfftcore/
    SFFTSubtract.py:172-178)."""
    from sfft_jax.utils.profiling import PhaseTimer

    t = PhaseTimer(verbose_level=2)
    with t.phase("setup"):
        pass
    with t.phase("work") as box:
        box["result"] = jnp.asarray([1.0, 2.0])
    got = t.report()
    out = capsys.readouterr().out
    assert "setup" in out and "work" in out and "TOTAL" in out
    assert set(got) == {"setup", "work"} and all(v >= 0 for v in got.values())


def _run(args, cwd, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_the_cpu(script):
    """Without a GPU the smoke run and the benchmark exit non-zero and print
    no result line."""
    out = _run([script], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository exits non-zero."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_poly_checks_on_cpu():
    """The 4096^2 phase's checks at 128^2 on the CPU: the LU solution's
    backward error sits far inside the bound."""
    cpu = jax.devices("cpu")[0]
    out = chip_smoke.phase_poly(cpu, n=128, w=2)
    assert out["backward_error"] < 1e-14


def test_chip_smoke_parity_checks_on_cpu():
    """The GPU-vs-CPU parity phases, both sides on the CPU at small sizes:
    identical runs deviate by nothing."""
    cpu = jax.devices("cpu")[0]
    sol_rel, rms = chip_smoke.phase_poly_parity(cpu, cpu, n=128, w=2)
    assert sol_rel == 0.0 and rms == 0.0


def test_chip_smoke_corrupted_solution_fails_bound():
    """A solution perturbed by 1e-9 relative must miss the 1e-12 backward
    error bound that the exact one meets."""
    from sfft_jax.core.engine import _solve_impl
    from sfft_jax.utils.synth import star_pair

    I, J = star_pair(128, 128, seed=0)
    cfg = make_config(128, 128, 2)
    sol = np.asarray(_solve_impl(cfg, jnp.asarray(I), jnp.asarray(J)))
    eta = chip_smoke.solution_backward_error(cfg, I, J, sol)
    chip_smoke.check(("exact solution", eta, chip_smoke.BACKWARD_ERROR_BOUND))
    noise = np.random.default_rng(0).standard_normal(sol.shape)
    bad = chip_smoke.solution_backward_error(cfg, I, J,
                                             sol * (1 + 1e-9 * noise))
    with pytest.raises(AssertionError):
        chip_smoke.check(("corrupted solution", bad,
                          chip_smoke.BACKWARD_ERROR_BOUND))


def test_lu_solver_equilibrated_matches_exact():
    """The default 'lu' solver equilibrates before factoring: on a raw
    1e13-conditioned system it lands next to the refined 'exact' solve."""
    from sfft_jax.core.engine import _solve_impl
    from sfft_jax.utils.synth import star_pair

    I, J = star_pair(256, 256, seed=1)
    x_lu = np.asarray(_solve_impl(make_config(256, 256, 4),
                                  jnp.asarray(I), jnp.asarray(J)))
    x_ex = np.asarray(_solve_impl(make_config(256, 256, 4, solver="exact"),
                                  jnp.asarray(I), jnp.asarray(J)))
    assert np.max(np.abs(x_lu - x_ex)) / np.max(np.abs(x_ex)) < 1e-7


def test_star_pair_seeded():
    from sfft_jax.utils.synth import star_pair

    a = star_pair(64, 48, seed=3)
    b = star_pair(64, 48, seed=3)
    c = star_pair(64, 48, seed=4)
    assert a[0].shape == a[1].shape == (64, 48)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert 50 < np.median(a[0]) < 500 and np.all(np.isfinite(a[1]))


# the Pallas backend of the old accelerator, its two env switches, and the
# "neither CPU nor GPU" platform test (character classes keep the names out
# of this file's own text)
_PLATFORM_BRANCH = re.compile(
    r"jax\.experimental\.pallas\.[t]pu|pl[t]pu|SFFT_PALLAS_SLICE"
    r"|SFFT_NO_PALLAS|not in \(\"cpu\", \"gpu\"\)")


@pytest.mark.parametrize("tree", ["sfft_jax", "tools", "bench.py",
                                  "__graft_entry__.py", "chip_smoke.py"])
def test_no_foreign_kernels_or_platform_branches(tree):
    """No module imports a Pallas backend other than the GPU's, reads the
    old Pallas switches, or branches on 'not CPU and not GPU'."""
    root = REPO / tree
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    hits = [f"{f.relative_to(REPO)}:{n}"
            for f in files
            for n, line in enumerate(f.read_text().splitlines(), 1)
            if _PLATFORM_BRANCH.search(line)]
    assert not hits, hits
