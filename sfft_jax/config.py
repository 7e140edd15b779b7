"""Static configuration for an SFFT solve.

The reference "compiles" 13 CUDA kernels per (N0, N1, KerHW, DK, DB,
ConstPhotRatio) tuple (reference: sfft/sfftcore/SFFTConfigure.py:7-815). Here the
equivalent is a frozen, hashable dataclass: everything shape-like is static, so a
jitted solve traces once per config and is cached by JAX exactly like the
reference's RawModule dict.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BasisSpec:
    """Spatial-variation basis for kernel / background / scaling.

    kind='polynomial': standard 2D polynomial with triangular multi-index
        {x^i y^j : i+j <= degree} in ScaledFortranCoor (reference convention:
        cx=(row+1)/N0, cy=(col+1)/N1; sfft/sfftcore/SFFTSubtract.py:545-560).
    kind='bspline': tensor-product clamped B-spline basis with `degree` and
        internal knots (reference: sfft/BSplineSFFT.py:2624-2645).
    """

    kind: str = "polynomial"  # 'polynomial' | 'bspline'
    degree: int = 2
    # internal knot positions in pixels along X / Y (bspline only); static tuple
    int_knots_x: Tuple[float, ...] = ()
    int_knots_y: Tuple[float, ...] = ()

    def num_funcs(self) -> int:
        if self.kind == "polynomial":
            return (self.degree + 1) * (self.degree + 2) // 2
        if self.kind == "bspline":
            fi = len(self.int_knots_x) + self.degree + 1
            fj = len(self.int_knots_y) + self.degree + 1
            return fi * fj
        raise ValueError(f"unknown basis kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SFFTConfig:
    """All static parameters of one SFFT problem instance."""

    N0: int  # image X size (axis 0, NAXIS1 after the .T convention)
    N1: int  # image Y size (axis 1, NAXIS2 after the .T convention)
    w0: int  # kernel half-width along X
    w1: int  # kernel half-width along Y
    kernel_basis: BasisSpec = BasisSpec()
    bg_basis: BasisSpec = BasisSpec()
    const_phot_ratio: bool = True
    # v2 engine: separate flux-scaling spatial basis (reference SCALING_MODE,
    # sfft/BSplineSFFT.py:49-75). None => ENTANGLED (scaling follows the kernel
    # basis; const_phot_ratio then picks v1 semantics). A degree-0 spec =>
    # SEPARATE-CONSTANT; higher degree => SEPARATE-VARYING.
    scaling_basis: Optional["BasisSpec"] = None
    # Tikhonov kernel regularization (v2 engine; sfft/BSplineSFFT.py:2010-2168):
    # lambda = 0.0 disables. reg_xy: static regularization sample points in
    # FortranCoor; reg_weights: optional per-point weights.
    regularize_lambda: float = 0.0
    reg_xy: Tuple[Tuple[float, float], ...] = ()
    reg_weights: Optional[Tuple[float, ...]] = None
    ignore_laplacian_kercent: bool = True
    # numerics
    dtype: str = "float64"  # 'float64' | 'float32'
    # greek backend: 'fft' (rfft2/irfft2 Hadamard path in the config dtype —
    # the default) | 'exact' (sliced-integer pair-FFT correlations,
    # core/exact_fft.py, any basis) | 'pexact' (peeled + sliced, polynomial
    # bases, core/pexact.py) | 'peeled' (smooth/fluct mixed precision — fast
    # mode) | 'fft32' (f32 FFT tables) | 'corr' (FFT-free lax.conv)
    greek_backend: str = "fft"
    # difference construction: 'fft' (Fourier-space, reference-equivalent) |
    # 'exact' / 'pexact' (pair-arithmetic spectra/inverse) | 'fft32'
    # | 'conv' (real-space circular convolution via lax.conv; complex-free)
    fdiff_backend: str = "fft"
    # linear solver: 'lu' | 'cho' | 'exact' (equilibrated blocked Cholesky
    # + f64-residual refinement) | 'refined' (f32 factor + refinement — fast
    # mode) | 'transformed' | 'host' (pure_callback to numpy) | 'blocked_cho'
    solver: str = "lu"
    # chunk size for the Greek pair axis (memory throttling; the reference's
    # MINIMIZE_GPU_MEMORY_USAGE analog). 0 = no chunking.
    greek_chunk: int = 0
    # 'peeled' backend knobs: degree of the exact polynomial peel and the dtype
    # of the fluctuation x fluctuation FFT part ('float32' in fast mode,
    # 'float64' for the exact cross-check).
    peel_degree: int = 3
    fluct_dtype: str = "float32"
    # 'pexact' backend knob: SliceProfile (nsl_data, nsl_static, kmax) of the
    # sliced pair-FFT on the PEELED fluctuation (core/pexact.py). The slicing
    # scales adapt to the fluctuation's own max, so (8, 7, 6) captures 48
    # bits of it — at worst (||F|| ~ ||I||) the plain exact backend's own
    # pair-representation floor, strictly better on smooth-dominated frames.
    # Lighter profiles trade table depth for speed.
    pexact_prof: Tuple[int, int, int] = (8, 7, 6)

    # ---- derived static quantities -------------------------------------
    @property
    def L0(self) -> int:
        return 2 * self.w0 + 1

    @property
    def L1(self) -> int:
        return 2 * self.w1 + 1

    @property
    def Fab(self) -> int:
        return self.L0 * self.L1

    @property
    def Fij(self) -> int:
        return self.kernel_basis.num_funcs()

    @property
    def Fpq(self) -> int:
        return self.bg_basis.num_funcs()

    @property
    def Fijab(self) -> int:
        return self.Fij * self.Fab

    @property
    def NEQ(self) -> int:
        return self.Fij * self.Fab + self.Fpq

    @property
    def SCALE(self) -> float:
        return 1.0 / (self.N0 * self.N1)

    @property
    def center_ab(self) -> int:
        # flat index of kernel offset (a, b) == (0, 0) in the (L0, L1) raster
        return self.w0 * self.L1 + self.w1

    @property
    def scaling_mode(self) -> str:
        if self.scaling_basis is None:
            return "ENTANGLED"
        if self.scaling_basis.degree == 0 and self.scaling_basis.kind == "polynomial":
            return "SEPARATE-CONSTANT"
        if (
            self.scaling_basis.kind == "bspline"
            and self.scaling_basis.degree == 0
            and not self.scaling_basis.int_knots_x
            and not self.scaling_basis.int_knots_y
        ):
            return "SEPARATE-CONSTANT"
        return "SEPARATE-VARYING"

    @property
    def ScaFij(self) -> int:
        if self.scaling_basis is None:
            return self.Fij
        return self.scaling_basis.num_funcs()

    @property
    def NEQt(self) -> int:
        """Tweaked system size (reference NEQt, sfft/BSplineSFFT.py:197-202)."""
        mode = self.scaling_mode
        if mode == "ENTANGLED":
            return self.NEQ - (self.Fij - 1) if self.const_phot_ratio else self.NEQ
        if mode == "SEPARATE-CONSTANT":
            return self.NEQ - self.Fij + 1
        return self.NEQ - (self.Fij - self.ScaFij)

    @property
    def NEQ_FSfree(self) -> int:
        if not self.const_phot_ratio:
            return self.NEQ
        return self.NEQ - (self.Fij - 1)

    def validate(self) -> None:
        if self.kernel_basis.kind == "polynomial" and self.kernel_basis.degree not in (0, 1, 2, 3):
            raise ValueError("kernel polynomial degree must be 0/1/2/3")
        if self.bg_basis.kind == "polynomial" and self.bg_basis.degree not in (0, 1, 2, 3):
            raise ValueError("background polynomial degree must be 0/1/2/3")
        if min(self.N0, self.N1) <= 4 * max(self.w0, self.w1):
            raise ValueError("image too small for the requested kernel half-width")


# Named precision/speed modes; make_config(mode=...) fills every backend knob
# not set explicitly.
#   contract — the reference's float64 semantics: complex128 FFT tables and
#              difference, LU solve. The default.
#   fast     — smooth/fluctuation-peeled tables with a float32 FFT for the
#              fluctuation part, float32 difference, f32-factor solve with
#              f64-residual refinement.
MODES = {
    "contract": dict(greek_backend="fft", fdiff_backend="fft", solver="lu"),
    "fast": dict(greek_backend="peeled", fdiff_backend="fft32",
                 solver="refined"),
}


@lru_cache(maxsize=128)
def make_config(
    NX: int,
    NY: int,
    KerHW: int,
    KerPolyOrder: int = 2,
    BGPolyOrder: int = 2,
    ConstPhotRatio: bool = True,
    dtype: str = "float64",
    greek_backend: Optional[str] = None,
    fdiff_backend: Optional[str] = None,
    solver: Optional[str] = None,
    greek_chunk: int = 0,
    mode: Optional[str] = None,
    pexact_prof: Optional[Tuple[int, int, int]] = None,
) -> SFFTConfig:
    """Reference-parameter-compatible constructor.

    Mirrors SingleSFFTConfigure.SSC(NX, NY, KerHW, KerPolyOrder, BGPolyOrder,
    ConstPhotRatio) (reference: sfft/sfftcore/SFFTConfigure.py:1369-1397).
    `mode` ('contract' | 'fast', see MODES; default 'contract') fills any
    backend knob not set explicitly. The result does not depend on the JAX
    backend.
    """
    if mode is None:
        mode = "contract"
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {sorted(MODES)}")
    sel = MODES[mode]
    extra = {}
    if pexact_prof is not None:
        extra["pexact_prof"] = tuple(int(x) for x in pexact_prof)

    cfg = SFFTConfig(
        N0=int(NX),
        N1=int(NY),
        w0=int(KerHW),
        w1=int(KerHW),
        kernel_basis=BasisSpec(kind="polynomial", degree=int(KerPolyOrder)),
        bg_basis=BasisSpec(kind="polynomial", degree=int(BGPolyOrder)),
        const_phot_ratio=bool(ConstPhotRatio),
        dtype=dtype,
        greek_backend=greek_backend or sel["greek_backend"],
        fdiff_backend=fdiff_backend or sel["fdiff_backend"],
        solver=solver or sel["solver"],
        greek_chunk=int(greek_chunk),
        **extra,
    )
    cfg.validate()
    return cfg


def np_dtype(cfg: SFFTConfig) -> np.dtype:
    return np.dtype(cfg.dtype)


def complex_dtype(cfg: SFFTConfig) -> np.dtype:
    return np.dtype("complex128" if cfg.dtype == "float64" else "complex64")
