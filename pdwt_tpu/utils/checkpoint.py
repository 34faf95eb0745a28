"""Coefficient checkpoint / resume.

The reference has no persistence; its primitives are get_coeff/set_coeff
round-trips (reference: src/wt.cu:437-508).  Here the coefficient pytree
is ordinary arrays, so checkpointing is a flat .npz with the tree
structure encoded in the keys — loadable with plain numpy anywhere.
"""
from __future__ import annotations

from typing import Tuple, Union

import ml_dtypes
import numpy as np

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D

Coeffs = Union[Coeffs1D, Coeffs2D, Coeffs3D]

_BF16 = np.dtype(ml_dtypes.bfloat16)


def _pack(data: dict, key: str, arr) -> None:
    # npz has no bfloat16 descriptor (it would silently round-trip as
    # raw void bytes); store as uint16 with a dtype tag instead.  Every
    # subband of the bf16-fast tier hits this.
    a = np.asarray(arr)
    if a.dtype == _BF16:
        data[key] = a.view(np.uint16)
        data[f"_dt_{key}"] = np.str_("bfloat16")
    else:
        data[key] = a


def _unpack(z, key: str) -> np.ndarray:
    a = z[key]
    if f"_dt_{key}" in z.files and str(z[f"_dt_{key}"]) == "bfloat16":
        return a.view(_BF16)
    return a


def save_coeffs(path: str, coeffs: Coeffs) -> None:
    """Write a coefficient pytree to ``path`` (.npz)."""
    data: dict = {}
    _pack(data, "approx", coeffs.approx)
    if isinstance(coeffs, Coeffs3D):
        data["ndim"] = np.int64(3)
        for i, bands in enumerate(coeffs.details):
            for j, b in enumerate(bands):  # 7 bands, key order b{i}_{j}
                _pack(data, f"b{i}_{j}", b)
    elif isinstance(coeffs, Coeffs2D):
        data["ndim"] = np.int64(2)
        for i, (h, v, d) in enumerate(coeffs.details):
            _pack(data, f"h{i}", h)
            _pack(data, f"v{i}", v)
            _pack(data, f"d{i}", d)
    else:
        data["ndim"] = np.int64(1)
        for i, d in enumerate(coeffs.details):
            _pack(data, f"d{i}", d)
    data["levels"] = np.int64(coeffs.levels)
    np.savez(path, **data)


def load_coeffs(path: str) -> Coeffs:
    """Load a coefficient pytree written by :func:`save_coeffs`."""
    with np.load(path) as z:
        levels = int(z["levels"])
        ndim = int(z["ndim"])
        approx = _unpack(z, "approx")
        if ndim == 3:
            details = tuple(
                tuple(_unpack(z, f"b{i}_{j}") for j in range(7))
                for i in range(levels)
            )
            return Coeffs3D(approx, details)
        if ndim == 2:
            details = tuple(
                (_unpack(z, f"h{i}"), _unpack(z, f"v{i}"),
                 _unpack(z, f"d{i}")) for i in range(levels)
            )
            return Coeffs2D(approx, details)
        return Coeffs1D(approx,
                        tuple(_unpack(z, f"d{i}") for i in range(levels)))
