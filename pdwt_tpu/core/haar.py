"""Haar butterflies — no convolution, just 2x2 / pairwise butterflies.

The reference takes this path when hlen == 2 and not SWT (reference:
src/wt.cu:248,255).  Here it is a functional entry point only: on an
H100 the generic fma passes run a 5-level 8192^2 haar roundtrip as fast
(1.637 vs 1.665 ms), so the ``Wavelets`` facade uses the generic passes
for every wavelet.  It lowers to strided-slice + elementwise work with
no gather or convolution.

Scaling conventions follow the reference exactly:
* 2D uses a single 0.5 factor applied to the 4-point butterflies
  (reference: src/haar.cu:4-5,32-35: "sqrt(2) applied after two HAAR_*").
* 1D uses 1/sqrt(2) per pairwise op (reference: src/haar.cu:128,143-144).

Subband roles: H = difference along rows (y), V = difference along
columns (x) (reference: src/haar.cu:32-35 writes DIF-over-y to c_h).
"""
from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
from jax import lax

from .conv import odd_extend
from .separable import Coeffs1D, Coeffs2D, _from_nchw, _to_nchw
from .shapes import level_sizes

_INV_SQRT2 = 0.7071067811865476


def _haar2d_level(x):
    """x: (B,1,H,W) -> (a, h, v, d) each (B,1,ceil(H/2),ceil(W/2))."""
    x = odd_extend(odd_extend(x, -1), -2)
    x00 = x[..., 0::2, 0::2]
    x01 = x[..., 0::2, 1::2]
    x10 = x[..., 1::2, 0::2]
    x11 = x[..., 1::2, 1::2]
    s = x.dtype.type(0.5)
    sum_y0 = x00 + x10   # AVG over y at x0
    sum_y1 = x01 + x11
    dif_y0 = x00 - x10
    dif_y1 = x01 - x11
    a = s * (sum_y0 + sum_y1)
    v = s * (sum_y0 - sum_y1)  # difference along x
    h = s * (dif_y0 + dif_y1)  # difference along y
    d = s * (dif_y0 - dif_y1)
    return a, h, v, d


def _interleave2(even, odd, axis):
    axis = axis % even.ndim
    y = jnp.stack([even, odd], axis=axis + 1)
    shape = even.shape[:axis] + (2 * even.shape[axis],) + even.shape[axis + 1 :]
    return y.reshape(shape)


def _haar2d_level_inv(a, h, v, d, out_shape):
    s = a.dtype.type(0.5)
    sum_y0 = a + v
    sum_y1 = a - v
    dif_y0 = h + d
    dif_y1 = h - d
    x00 = s * (sum_y0 + dif_y0)
    x10 = s * (sum_y0 - dif_y0)
    x01 = s * (sum_y1 + dif_y1)
    x11 = s * (sum_y1 - dif_y1)
    top = _interleave2(x00, x01, axis=-1)
    bot = _interleave2(x10, x11, axis=-1)
    out = _interleave2(top, bot, axis=-2)
    out = lax.slice_in_dim(out, 0, out_shape[0], axis=-2)
    out = lax.slice_in_dim(out, 0, out_shape[1], axis=-1)
    return out


def haar_dwt2d(x: jnp.ndarray, levels: int) -> Coeffs2D:
    arr, batch = _to_nchw(x, 2)
    details: List[Tuple[jnp.ndarray, ...]] = []
    a = arr
    for _ in range(levels):
        a, h, v, d = _haar2d_level(a)
        details.append(tuple(_from_nchw(t, batch, 2) for t in (h, v, d)))
    return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))


def haar_idwt2d(coeffs: Coeffs2D, shape: Tuple[int, int]) -> jnp.ndarray:
    levels = coeffs.levels
    rows = level_sizes(shape[0], levels)
    cols = level_sizes(shape[1], levels)
    a, batch = _to_nchw(coeffs.approx, 2)
    for i in range(levels - 1, -1, -1):
        h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
        a = _haar2d_level_inv(a, h, v, d, (rows[i], cols[i]))
    return _from_nchw(a, batch, 2)


def _haar1d_level(x):
    x = odd_extend(x, -1)
    e, o = x[..., 0::2], x[..., 1::2]
    s = x.dtype.type(_INV_SQRT2)
    return s * (e + o), s * (e - o)


def haar_dwt1d(x: jnp.ndarray, levels: int) -> Coeffs1D:
    arr, batch = _to_nchw(x, 1)
    details: List[jnp.ndarray] = []
    a = arr
    for _ in range(levels):
        a, d = _haar1d_level(a)
        details.append(_from_nchw(d, batch, 1))
    return Coeffs1D(_from_nchw(a, batch, 1), tuple(details))


def haar_idwt1d(coeffs: Coeffs1D, length: int) -> jnp.ndarray:
    sizes = level_sizes(length, coeffs.levels)
    a, batch = _to_nchw(coeffs.approx, 1)
    for i in range(coeffs.levels - 1, -1, -1):
        d, _ = _to_nchw(coeffs.details[i], 1)
        s = a.dtype.type(_INV_SQRT2)
        out = _interleave2(s * (a + d), s * (a - d), axis=-1)
        a = lax.slice_in_dim(out, 0, sizes[i], axis=-1)
    return _from_nchw(a, batch, 1)
