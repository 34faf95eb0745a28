"""Boundary extension modes for the decimated DWT.

The reference implements only the periodic boundary extension and lists
that as its own limitation (reference: README.md:33 "Only the periodic
boundary extension is implemented").  This module supplies the full
PyWavelets mode set so pipelines written against ``pywt.wavedec*`` can
migrate without changing their boundary handling:

========================  ====================================================
``periodization``         the reference scheme (default): periodic wrap with
                          odd-size virtual extension, ``ceil(N/2)`` outputs
                          per level (reference: src/separable.cu:111-121)
``zero``                  ... 0 0 | x0 .. xN-1 | 0 0 ...
``constant``              ... x0 x0 | x | xN-1 xN-1 ...          (edge hold)
``symmetric``             ... x1 x0 | x | xN-1 xN-2 ...          (half-point)
``reflect``               ... x2 x1 | x | xN-2 xN-3 ...          (whole-point)
``periodic``              ... xN-2 xN-1 | x | x0 x1 ...  (wrap, pywt lengths)
``smooth``                linear extrapolation with the edge slope
``antisymmetric``         ... -x1 -x0 | x | -xN-1 -xN-2 ...  (half-point, odd)
``antireflect``           ... 2x0-x2 2x0-x1 | x | 2xN-1-xN-2 ... (whole-point,
                          odd — point reflection about the edge sample)
========================  ====================================================

Semantics follow the PyWavelets C implementation exactly (pywt
``_extensions/c/convolution.c``: true convolution ``out[m] = sum_j f[j]
x_ext[2m+1-j]`` with ``floor((N+F-1)/2)`` outputs; ``common.c`` for the
extension fills), so coefficients are numerically equal to
``pywt.wavedec*(..., mode=<mode>)`` for every wavelet whose filter bank
matches pywt's published coefficients.  The inverse needs NO boundary
extension (pywt ``upsampling_convolution_valid_sf``): it is a valid
correlation of the zero-stuffed coefficients producing ``2M - F + 2``
samples, sliced to the stored next-level length.

Every extension is evaluated as a *gather with affine edge terms*:

    ext[t] = s[t] * x[idx[t]] + a[t] * x[0] + b[t] * x[N-1]

with the integer/sign maps computed in numpy at trace time (pad widths
are static).  This handles extension widths wider than the signal
(filters longer than the input) by exact reflection cycling — including
the offset accumulation of ``antireflect`` — matching pywt's repeated
re-extension loops in closed form.
"""
from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np
from jax import lax

MODES = (
    "periodization",
    "zero",
    "constant",
    "symmetric",
    "reflect",
    "periodic",
    "smooth",
    "antisymmetric",
    "antireflect",
)


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown boundary mode {mode!r}; expected one of "
                         f"{MODES}")
    return mode


def per_axis(mode, ndim: int):
    """Normalize a mode argument to one mode per spatial axis (pywt
    semantics: a single string applies to every axis, a tuple/list
    gives one mode per transformed axis, in axis order — e.g. 2D
    ``(row_mode, col_mode)``)."""
    if isinstance(mode, str):
        return (check_mode(mode),) * ndim
    modes = tuple(mode)
    if len(modes) != ndim:
        raise ValueError(
            f"expected {ndim} boundary modes (one per transformed axis), "
            f"got {len(modes)}: {modes!r}")
    return tuple(check_mode(m) for m in modes)


def dec_len(n: int, hlen: int, mode: str = "periodization") -> int:
    """Per-level coefficient length.  ``periodization``: ``ceil(N/2)``
    (reference: src/utils.cu:23-27); every other mode uses the pywt rule
    ``floor((N + hlen - 1) / 2)``."""
    if mode == "periodization":
        return (n + 1) // 2
    return (n + hlen - 1) // 2


def rec_len(m: int, hlen: int, mode: str = "periodization") -> int:
    """Full inverse output length before slicing to the stored size."""
    if mode == "periodization":
        return 2 * m
    return 2 * m - hlen + 2


def level_sizes(n: int, levels: int, hlen: int,
                mode: str = "periodization") -> List[int]:
    """[n, dec_len(n), dec_len(dec_len(n)), ...] — length levels+1."""
    sizes = [n]
    for _ in range(levels):
        sizes.append(dec_len(sizes[-1], hlen, mode))
    return sizes


def _ext_maps(n: int, pos: np.ndarray, mode: str):
    """(s, idx, a, b) f64/int maps such that ext[t] = s*x[idx] + a*x0 +
    b*x[N-1] reproduces the pywt extension value at every position in
    ``pos`` (integers outside [0, N))."""
    s = np.ones(pos.shape)
    a = np.zeros(pos.shape)
    b = np.zeros(pos.shape)
    if mode == "zero":
        return np.zeros(pos.shape), np.zeros(pos.shape, np.int64), a, b
    if mode == "constant":
        idx = np.where(pos < 0, 0, n - 1)
        return s, idx, a, b
    if mode == "periodic":
        return s, pos % n, a, b
    if mode in ("symmetric", "antisymmetric"):
        m = pos % (2 * n)
        idx = np.where(m < n, m, 2 * n - 1 - m)
        if mode == "antisymmetric":
            s = np.where(m < n, 1.0, -1.0)
        return s, idx, a, b
    if mode == "smooth":
        if n == 1:  # pywt falls back to edge replication
            return s, np.zeros(pos.shape, np.int64), a, b
        # left t<0: (1-t)*x0 + t*x1 ; right t>=N: x[N-1] + (t-N+1)*(x[N-1]-x[N-2])
        left = pos < 0
        idx = np.where(left, 1, n - 2)
        s = np.where(left, pos, -(pos - n + 1)).astype(np.float64)
        a = np.where(left, 1.0 - pos, 0.0)
        b = np.where(left, 0.0, pos - n + 2.0)
        return s, idx, a, b
    if mode in ("reflect", "antireflect"):
        if n < 2:
            raise ValueError(
                f"mode {mode!r} needs at least 2 samples along the axis")
        p = 2 * n - 2
        m = pos % p
        q = pos // p  # completed reflection periods (negative to the left)
        inner = m < n
        idx = np.where(inner, m, p - m)
        if mode == "reflect":
            return s, idx, a, b
        # antireflect: each period adds 2*(x[N-1] - x[0]); the reflected
        # half is point-mirrored about x[N-1] within its period.
        s = np.where(inner, 1.0, -1.0)
        a = -2.0 * q.astype(np.float64)
        b = np.where(inner, 2.0 * q, 2.0 * q + 2.0)
        return s, idx, a, b
    raise ValueError(f"unknown boundary mode {mode!r}")


def _shaped(v: np.ndarray, ndim: int, axis: int, dtype) -> jnp.ndarray:
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return jnp.asarray(v.reshape(shape), dtype=dtype)


def _rev_slice(x, axis, start, stop):
    """Reversed contiguous slice along ``axis`` (flip of a tiny edge
    strip — lowers as rev+slice, no gather)."""
    return lax.rev(lax.slice_in_dim(x, start, stop, axis=axis), (axis,))


def _ext_block(x: jnp.ndarray, axis: int, pos: np.ndarray,
               mode: str) -> jnp.ndarray:
    n = x.shape[axis]
    w = pos.shape[0]
    left = bool(pos[0] < 0)
    dt = x.dtype

    # Gather-free fast paths for single-cycle widths: a flip/slice/
    # broadcast of the tiny edge strip instead of a jnp.take gather
    # along an array axis.
    if mode == "constant" or (mode == "smooth" and n == 1):
        edge = lax.slice_in_dim(x, 0, 1, axis=axis) if left \
            else lax.slice_in_dim(x, n - 1, n, axis=axis)
        reps = [1] * x.ndim
        reps[axis] = w
        return jnp.tile(edge, reps)
    if mode in ("symmetric", "antisymmetric") and w <= n:
        strip = (_rev_slice(x, axis, 0, w) if left
                 else _rev_slice(x, axis, n - w, n))
        return -strip if mode == "antisymmetric" else strip
    if mode in ("reflect", "antireflect") and w <= n - 1:
        strip = (_rev_slice(x, axis, 1, w + 1) if left
                 else _rev_slice(x, axis, n - 1 - w, n - 1))
        if mode == "antireflect":
            edge = (lax.slice_in_dim(x, 0, 1, axis=axis) if left
                    else lax.slice_in_dim(x, n - 1, n, axis=axis))
            return 2.0 * edge.astype(dt) - strip
        return strip
    if mode == "periodic" and w <= n:
        return (lax.slice_in_dim(x, n - w, n, axis=axis) if left
                else lax.slice_in_dim(x, 0, w, axis=axis))
    if mode == "smooth":
        x0 = lax.slice_in_dim(x, 0, 1, axis=axis)
        x1 = lax.slice_in_dim(x, 1, 2, axis=axis)
        xm = lax.slice_in_dim(x, n - 1, n, axis=axis)
        xp = lax.slice_in_dim(x, n - 2, n - 1, axis=axis)
        k = _shaped(np.arange(1, w + 1, dtype=np.float64)[::-1] if left
                    else np.arange(1, w + 1, dtype=np.float64),
                    x.ndim, axis, dt)
        return (x0 + k * (x0 - x1)) if left else (xm + k * (xm - xp))

    # general case (pads wider than the signal: reflection cycling,
    # antireflect offset accumulation) — closed-form gather + affine
    s, idx, a, b = _ext_maps(n, pos, mode)
    if not s.any() and not a.any() and not b.any():
        shape = list(x.shape)
        shape[axis] = w
        return jnp.zeros(shape, dt)
    out = None
    if s.any():
        g = jnp.take(x, jnp.asarray(idx), axis=axis)
        if not (s == 1.0).all():
            g = g * _shaped(s, x.ndim, axis, dt)
        out = g
    if a.any():
        t = lax.slice_in_dim(x, 0, 1, axis=axis) * _shaped(a, x.ndim, axis, dt)
        out = t if out is None else out + t
    if b.any():
        t = (lax.slice_in_dim(x, n - 1, n, axis=axis)
             * _shaped(b, x.ndim, axis, dt))
        out = t if out is None else out + t
    return out


def extend(x: jnp.ndarray, axis: int, lo: int, hi: int,
           mode: str) -> jnp.ndarray:
    """Pad ``x`` along ``axis`` by ``lo``/``hi`` samples of the mode's
    boundary extension (pywt ``common.c`` semantics, any width).

    ``"periodization"`` pads periodically here (its odd-size virtual
    extension is the TRANSFORM's concern — conv.py applies odd_extend
    before padding), so the helper works generically over ``MODES``."""
    check_mode(mode)
    if mode == "periodization":
        mode = "periodic"
    axis = axis % x.ndim
    n = x.shape[axis]
    parts = []
    if lo:
        parts.append(_ext_block(x, axis, np.arange(-lo, 0), mode))
    parts.append(x)
    if hi:
        parts.append(_ext_block(x, axis, np.arange(n, n + hi), mode))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=axis)


def zero_pad(x: jnp.ndarray, axis: int, lo: int, hi: int) -> jnp.ndarray:
    """Zero padding along one axis (the non-periodization inverse pads the
    zero-stuffed coefficient array — no boundary extension, see module
    docstring)."""
    if lo == 0 and hi == 0:
        return x
    cfg = [(0, 0, 0)] * x.ndim
    cfg[axis % x.ndim] = (lo, hi, 0)
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)
