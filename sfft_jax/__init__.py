"""sfft_jax — JAX framework for Fourier-space astronomical image subtraction.

A from-scratch rebuild of the capabilities of thomasvrussell/sfft (Hu et al. 2022,
ApJ 936, 157): solve a spatially-varying PSF-matching kernel K_xy plus a
spatially-varying differential background B_xy such that J ~= I (*) K_xy + B_xy,
and emit the difference D = J - (I (*) K_xy + B_xy).

Design notes (a rebuild, not a port):
  * One generalized engine covers the reference's three near-duplicate engines
    (sfftcore Cupy/Numpy, PureCupy, BSplineSFFT): polynomial and B-spline spatial
    bases are both just stacks of basis planes.
  * The reference's 13 runtime-compiled CUDA kernels collapse into: basis stacks
    (broadcasting), Hadamard+FFT Greek tensors (batched rfft2/irfft2 exploiting
    Hermitian symmetry the reference leaves on the table), static gather-based
    normal-equation assembly, a dense solve, and a matmul-factorized difference
    spectrum. See sfft_jax/core/.
  * float64 is the precision contract (reference is float64/complex128
    throughout). We enable jax x64 at import; the default path runs
    complex128 FFTs and an f64 LU solve (cuFFT and cuSOLVER on an NVIDIA
    GPU). Opt-in engines emulate f64 with sliced-integer products or split
    the work into exact moments and a complex64 FFT (core/exact_fft.py,
    core/pexact.py, core/peel.py).
"""

import jax as _jax

# The reference algorithm is float64/complex128 end-to-end; parity at 1e-6 RMS
# requires x64. Enable before any tracing happens.
_jax.config.update("jax_enable_x64", True)

from sfft_jax.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

from sfft_jax.config import SFFTConfig, make_config  # noqa: E402
from sfft_jax.core.engine import (  # noqa: E402
    ElementalSFFT,
    GeneralSFFT,
    elemental_subtract,
    general_subtract,
)
from sfft_jax.api.customized import CustomizedPacket, PureJAXCustomizedPacket  # noqa: E402

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports for the heavier pipeline packets
    if name == "EasySparsePacket":
        from sfft_jax.api.easy_sparse import EasySparsePacket

        return EasySparsePacket
    if name == "EasyCrowdedPacket":
        from sfft_jax.api.easy_crowded import EasyCrowdedPacket

        return EasyCrowdedPacket
    if name == "BSplinePacket":
        from sfft_jax.api.bspline import BSplinePacket

        return BSplinePacket
    if name == "MultiEasySparsePacket":
        from sfft_jax.parallel.scheduler import MultiEasySparsePacket

        return MultiEasySparsePacket
    if name == "MultiEasyCrowdedPacket":
        from sfft_jax.parallel.scheduler import MultiEasyCrowdedPacket

        return MultiEasyCrowdedPacket
    if name in ("EngineClient", "EngineServer", "ensure_server"):
        import sfft_jax.serve as _serve

        return getattr(_serve, name)
    raise AttributeError(name)


__all__ = [
    "SFFTConfig",
    "make_config",
    "ElementalSFFT",
    "GeneralSFFT",
    "elemental_subtract",
    "general_subtract",
    "CustomizedPacket",
    "PureJAXCustomizedPacket",
    "EasySparsePacket",
    "EasyCrowdedPacket",
    "BSplinePacket",
    "MultiEasySparsePacket",
    "MultiEasyCrowdedPacket",
    "EngineClient",
    "EngineServer",
    "ensure_server",
]
