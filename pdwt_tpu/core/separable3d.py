"""Separable multi-level 3D DWT / SWT, forward and inverse.

The reference explicitly does NOT support 3D ("3D is not handled at the
moment", reference: README.md "Current limitations") — this module closes
that gap with the same index semantics extended to a third axis: every
pass is the 1D analysis/synthesis of core/conv.py (one spec, all
backends), applied along columns, rows, then depth.

Coefficient layout: ``Coeffs3D(approx, details)`` with ``details[i]`` a
7-tuple for level i+1, ordered by the analysis channel index

    ch = 4*k_col + 2*k_row + 1*k_dep          (k = 0 lowpass, 1 highpass)

which corresponds to pywt's ``dwtn`` keys (axis order depth, row, col):

    DETAIL_KEYS_3D = (daa, ada, dda, aad, dad, add, ddd)

e.g. ``details[i][0]`` is highpass along depth only.  The 2D convention
(H = highpass along rows first) is the middle-axis analogue.

"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..filters import Wavelet
from . import conv
from .precision import takes_precision

#: pywt-style subband keys (axis order depth,row,col) for details[i][j].
DETAIL_KEYS_3D = ("daa", "ada", "dda", "aad", "dad", "add", "ddd")


class Coeffs3D(NamedTuple):
    approx: jnp.ndarray
    details: Tuple[Tuple[jnp.ndarray, ...], ...]  # 7 bands per level

    @property
    def levels(self) -> int:
        return len(self.details)


def _to_ncs(x: jnp.ndarray):
    """(..., D, R, C) -> ((B, 1, D, R, C), batch_shape)."""
    if x.ndim < 3:
        raise ValueError(f"expected at least 3D input, got shape {x.shape}")
    batch = x.shape[:-3]
    d, r, c = x.shape[-3:]
    b = int(np.prod(batch, dtype=np.int64)) if batch else 1
    return x.reshape((b, 1, d, r, c)), batch


def _from_ncs(x: jnp.ndarray, batch):
    return x.reshape(batch + x.shape[-3:])


@takes_precision
def dwt3d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          mode="periodization") -> Coeffs3D:
    """Multi-level separable 3D DWT over the trailing three axes.

    Semantics per axis are exactly core/conv.py's analysis spec
    (reference: src/separable.cu:91-131, generalized to the axis the
    reference does not have: its README lists "3D is not handled" as the
    first limitation).  ``mode`` selects the boundary extension
    (core/modes.py) — a string or a ``(depth, row, col)`` tuple (pywt
    per-axis semantics).
    """
    from .modes import per_axis

    mode_d, mode_r, mode_c = per_axis(mode, 3)
    arr, batch = _to_ncs(x)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[Tuple[jnp.ndarray, ...]] = []
    a = arr
    for _ in range(levels):
        t = conv.analysis_pass(a, dec, axis=-1, backend=backend,
                               pad_fn=pad_fn, mode=mode_c)
        t = conv.analysis_pass(t, dec, axis=-2, backend=backend,
                               pad_fn=pad_fn, mode=mode_r)
        z = conv.analysis_pass(t, dec, axis=-3, backend=backend,
                               pad_fn=pad_fn, mode=mode_d)
        a = z[:, 0:1]
        details.append(tuple(_from_ncs(z[:, k:k + 1], batch)
                             for k in range(1, 8)))
    return Coeffs3D(_from_ncs(a, batch), tuple(details))


@takes_precision
def idwt3d(coeffs: Coeffs3D, wav: Wavelet,
           shape: Tuple[int, int, int], *,
           backend: Optional[str] = None, pad_fn=None,
           mode="periodization") -> jnp.ndarray:
    """Inverse of :func:`dwt3d`; ``shape`` = (Nd, Nr, Nc)."""
    from .modes import level_sizes as _mode_sizes
    from .modes import per_axis

    mode_d, mode_r, mode_c = per_axis(mode, 3)
    levels = coeffs.levels
    deps = _mode_sizes(shape[0], levels, wav.hlen, mode_d)
    rows = _mode_sizes(shape[1], levels, wav.hlen, mode_r)
    cols = _mode_sizes(shape[2], levels, wav.hlen, mode_c)
    rec = (wav.rec_lo, wav.rec_hi)
    a, batch = _to_ncs(coeffs.approx)
    for i in range(levels - 1, -1, -1):
        bands = [_to_ncs(c)[0] for c in coeffs.details[i]]
        # synthesis in reverse analysis order: depth, rows, cols — each
        # pass combines groups of 2 consecutive channels (the k bit of
        # that axis is the least-significant one remaining).
        z = jnp.concatenate([a] + bands, axis=1)
        t = conv.synthesis_pass(z, rec, axis=-3, out_len=deps[i],
                                backend=backend, pad_fn=pad_fn, mode=mode_d)
        t = conv.synthesis_pass(t, rec, axis=-2, out_len=rows[i],
                                backend=backend, pad_fn=pad_fn, mode=mode_r)
        a = conv.synthesis_pass(t, rec, axis=-1, out_len=cols[i],
                                backend=backend, pad_fn=pad_fn, mode=mode_c)
    return _from_ncs(a, batch)


# ---------------------------------------------------------------------------
# 3D stationary (a-trous)
# ---------------------------------------------------------------------------

@takes_precision
def swt3d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          keep_approx: bool = False):
    """Stationary (undecimated) 3D transform; filter dilated by
    2^(level-1) per level, no subsampling.  ``keep_approx=True`` also
    returns the per-level approximation stack (multi-resolution)."""
    arr, batch = _to_ncs(x)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[Tuple[jnp.ndarray, ...]] = []
    approxs: List[jnp.ndarray] = []
    a = arr
    for lvl in range(1, levels + 1):
        f = 1 << (lvl - 1)
        t = conv.analysis_pass(a, dec, axis=-1, dilation=f,
                               decimate=False, backend=backend,
                               pad_fn=pad_fn)
        t = conv.analysis_pass(t, dec, axis=-2, dilation=f,
                               decimate=False, backend=backend,
                               pad_fn=pad_fn)
        z = conv.analysis_pass(t, dec, axis=-3, dilation=f,
                               decimate=False, backend=backend,
                               pad_fn=pad_fn)
        a = z[:, 0:1]
        details.append(tuple(_from_ncs(z[:, k:k + 1], batch)
                             for k in range(1, 8)))
        if keep_approx:
            approxs.append(_from_ncs(a, batch))
    coeffs = Coeffs3D(_from_ncs(a, batch), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


@takes_precision
def iswt3d(coeffs: Coeffs3D, wav: Wavelet, *,
           backend: Optional[str] = None, pad_fn=None) -> jnp.ndarray:
    """Inverse stationary 3D transform.  Each separable synthesis pass
    halves the taps (the 2D reference divides by 2 per pass,
    src/separable.cu:581-584; three passes give the 1/8 that averages
    the 3D redundancy)."""
    rec = (wav.rec_lo * 0.5, wav.rec_hi * 0.5)
    a, batch = _to_ncs(coeffs.approx)
    for i in range(coeffs.levels - 1, -1, -1):
        f = 1 << i
        bands = [_to_ncs(c)[0] for c in coeffs.details[i]]
        z = jnp.concatenate([a] + bands, axis=1)
        t = conv.synthesis_pass(z, rec, axis=-3, dilation=f,
                                decimated=False, backend=backend,
                                pad_fn=pad_fn)
        t = conv.synthesis_pass(t, rec, axis=-2, dilation=f,
                                decimated=False, backend=backend,
                                pad_fn=pad_fn)
        a = conv.synthesis_pass(t, rec, axis=-1, dilation=f,
                                decimated=False, backend=backend,
                                pad_fn=pad_fn)
    return _from_ncs(a, batch)


@takes_precision
def iswt3d_denoise(coeffs: Coeffs3D, wav: Wavelet, beta, *,
                   mode: str = "soft", normalize: bool = False,
                   do_thresh_appcoeffs: bool = False,
                   backend: Optional[str] = None) -> jnp.ndarray:
    """Detail threshold followed by the inverse 3D SWT (the volume
    analogue of separable.iswt2d_denoise): the same result as
    ops.soft/hard/garrote_threshold then :func:`iswt3d`."""
    from .. import ops as _ops

    fn = {"soft": _ops.soft_threshold, "hard": _ops.hard_threshold,
          "garrote": _ops.garrote_threshold}[mode]
    c2 = fn(coeffs, beta, normalize=normalize,
            do_thresh_appcoeffs=do_thresh_appcoeffs)
    return iswt3d(c2, wav, backend=backend)
