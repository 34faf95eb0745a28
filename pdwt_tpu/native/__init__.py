"""ctypes bindings to the native CPU engine (cpp/pdwt_cpu.cpp).

The native library is the double-accumulation CPU oracle and standalone
CLI backend; the JAX engine is the device compute path.  The shared object
is built on demand with the repo Makefile (g++; no pip deps).
"""
from .lib import (
    axpy,
    build,
    dwt1d,
    dwt2d,
    dwt2d_ns,
    dwt3d,
    firm_threshold,
    garrote_threshold,
    group_soft_threshold,
    idwt1d,
    idwt2d,
    idwt2d_ns,
    idwt3d,
    is_available,
    norm1,
    norm2sq,
    norm_l21,
    shrink,
    soft_threshold,
)

__all__ = [
    "build", "is_available",
    "dwt2d", "idwt2d", "dwt1d", "idwt1d", "dwt3d", "idwt3d",
    "dwt2d_ns", "idwt2d_ns",
    "soft_threshold", "group_soft_threshold", "shrink", "axpy",
    "garrote_threshold", "firm_threshold",
    "norm1", "norm2sq", "norm_l21",
]
