"""Separable multi-level DWT / SWT, forward and inverse.

Functional equivalents of the reference separable engines
(reference: src/separable.cu):

* ``dwt2d`` / ``idwt2d``   — w_forward_separable / w_inverse_separable
  (reference: src/separable.cu:179-209, 332-364)
* ``dwt1d`` / ``idwt1d``   — the batched-1D variants (src/separable.cu:214-236,
  368-395); any leading dimensions act as the batch
* ``swt2d`` / ``iswt2d``   — w_forward_swt_separable / w_inverse_swt_separable
  (src/separable.cu:496-537, 629-672)
* ``swt1d`` / ``iswt1d``

Coefficient layout mirrors the reference buffer layout
``[A_n, (H1,V1,D1), ..., (Hn,Vn,Dn)]`` / ``[A_n, D1..Dn]``
(reference: src/common.cu:399-445) as a JAX pytree:
``Coeffs2D(approx, details)`` with ``details[i] = (H,V,D)`` for level i+1.

Subband convention: H = highpass along rows (y), V = highpass along
columns (x), matching the reference separable engine
(reference: src/separable.cu:155-169: pass2 applies L/H vertically to the
horizontally-lowpassed temp for A/H).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..filters import Wavelet
from . import conv
from .precision import takes_precision


class Coeffs2D(NamedTuple):
    approx: jnp.ndarray
    details: Tuple[Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray], ...]

    @property
    def levels(self) -> int:
        return len(self.details)


class Coeffs1D(NamedTuple):
    approx: jnp.ndarray
    details: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def _to_nchw(x: jnp.ndarray, ndim_spatial: int):
    """(..., H, W) or (..., N) -> (B, 1, H, W); returns (arr, batch_shape)."""
    if ndim_spatial == 2:
        if x.ndim < 2:
            raise ValueError(f"expected at least 2D input, got shape {x.shape}")
        batch = x.shape[:-2]
        h, w = x.shape[-2:]
        return x.reshape((int(np.prod(batch, dtype=np.int64)), 1, h, w)), batch
    else:
        if x.ndim < 1:
            raise ValueError("expected at least 1D input")
        batch = x.shape[:-1]
        n = x.shape[-1]
        # batched-1D: fold the batch into H so one conv handles all rows,
        # the analogue of the reference's rows-as-batch kernels
        # (reference: src/separable.cu:213-236).
        return x.reshape((1, 1, int(np.prod(batch, dtype=np.int64)), n)), batch


def _from_nchw(x: jnp.ndarray, batch, ndim_spatial: int):
    if ndim_spatial == 2:
        return x.reshape(batch + x.shape[-2:])
    return x.reshape(batch + x.shape[-1:])



# ---------------------------------------------------------------------------
# 2D decimated
# ---------------------------------------------------------------------------

def _all_periodization(mode) -> bool:
    """True when ``mode`` (a string or per-axis tuple) is entirely the
    reference's periodization scheme."""
    if isinstance(mode, str):
        return mode == "periodization"
    return all(m == "periodization" for m in mode)


@takes_precision
def dwt2d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          mode="periodization") -> Coeffs2D:
    """Multi-level separable 2D DWT over the trailing two axes.

    ``mode`` selects the boundary extension (core/modes.py; pywt mode
    set) — a string for both axes or a ``(row_mode, col_mode)`` tuple
    (pywt per-axis semantics).  The default ``"periodization"`` is the
    reference scheme."""
    from .modes import per_axis

    mode_r, mode_c = per_axis(mode, 2)
    arr, batch = _to_nchw(x, 2)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[Tuple[jnp.ndarray, ...]] = []
    a = arr
    for _ in range(levels):
        t = conv.analysis_pass(a, dec, axis=-1, backend=backend,
                               pad_fn=pad_fn, mode=mode_c)
        z = conv.analysis_pass(t, dec, axis=-2, backend=backend,
                               pad_fn=pad_fn, mode=mode_r)
        a = z[:, 0:1]
        details.append(tuple(
            _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
        ))
    return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))


@takes_precision
def idwt2d(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], *,
           backend: Optional[str] = None, pad_fn=None,
           mode="periodization") -> jnp.ndarray:
    """Inverse of :func:`dwt2d`; ``shape`` = (Nr, Nc) of the original image."""
    from .modes import level_sizes as _mode_sizes
    from .modes import per_axis

    mode_r, mode_c = per_axis(mode, 2)
    levels = coeffs.levels
    rows = _mode_sizes(shape[0], levels, wav.hlen, mode_r)
    cols = _mode_sizes(shape[1], levels, wav.hlen, mode_c)
    rec = (wav.rec_lo, wav.rec_hi)
    a, batch = _to_nchw(coeffs.approx, 2)
    for i in range(levels - 1, -1, -1):
        h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
        z = jnp.concatenate([a, h, v, d], axis=1)  # (B,4,mr,mc)
        t = conv.synthesis_pass(z, rec, axis=-2, out_len=rows[i],
                                backend=backend, pad_fn=pad_fn,
                                mode=mode_r)  # (B,2,Hr,mc)
        a = conv.synthesis_pass(t, rec, axis=-1, out_len=cols[i],
                                backend=backend, pad_fn=pad_fn,
                                mode=mode_c)  # (B,1,Hr,Wc)
    return _from_nchw(a, batch, 2)


# ---------------------------------------------------------------------------
# 2D stationary (a-trous)
# ---------------------------------------------------------------------------

@takes_precision
def swt2d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          keep_approx: bool = False):
    """Stationary (à-trous) 2D wavelet transform.

    ``keep_approx=True`` additionally returns the per-level approximation
    stack ``(A_1, …, A_levels)`` — the multi-resolution feature the
    reference's TODO.txt asks for ("return all app coeffs") but only
    stores the last of (reference: src/separable.cu:496-537).  Returns
    ``(Coeffs2D, approxs)`` in that case; ``approxs[-1]`` is
    ``coeffs.approx``.
    """
    arr, batch = _to_nchw(x, 2)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[Tuple[jnp.ndarray, ...]] = []
    approxs: List[jnp.ndarray] = []
    a = arr
    for lvl in range(1, levels + 1):
        f = 1 << (lvl - 1)
        t = conv.analysis_pass(a, dec, axis=-1, dilation=f, decimate=False,
                               backend=backend, pad_fn=pad_fn)
        z = conv.analysis_pass(t, dec, axis=-2, dilation=f, decimate=False,
                               backend=backend, pad_fn=pad_fn)
        a = z[:, 0:1]
        details.append(tuple(
            _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
        ))
        if keep_approx:
            approxs.append(_from_nchw(a, batch, 2))
    coeffs = Coeffs2D(_from_nchw(a, batch, 2), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


@takes_precision
def iswt2d(coeffs: Coeffs2D, wav: Wavelet, *,
           backend: Optional[str] = None, pad_fn=None) -> jnp.ndarray:
    # Each separable synthesis pass halves the taps
    # (reference: src/separable.cu:581-584,621-622).
    rec = (wav.rec_lo * 0.5, wav.rec_hi * 0.5)
    a, batch = _to_nchw(coeffs.approx, 2)
    for i in range(coeffs.levels - 1, -1, -1):
        f = 1 << i
        h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
        z = jnp.concatenate([a, h, v, d], axis=1)
        t = conv.synthesis_pass(z, rec, axis=-2, dilation=f, decimated=False,
                                backend=backend, pad_fn=pad_fn)
        a = conv.synthesis_pass(t, rec, axis=-1, dilation=f, decimated=False,
                                backend=backend, pad_fn=pad_fn)
    return _from_nchw(a, batch, 2)


# ---------------------------------------------------------------------------
# 1D (batched over leading dims)
# ---------------------------------------------------------------------------

@takes_precision
def dwt1d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          mode="periodization") -> Coeffs1D:
    from .modes import per_axis

    (mode,) = per_axis(mode, 1)
    arr, batch = _to_nchw(x, 1)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[jnp.ndarray] = []
    a = arr
    for _ in range(levels):
        z = conv.analysis_pass(a, dec, axis=-1, backend=backend,
                               pad_fn=pad_fn, mode=mode)
        a = z[:, 0:1]
        details.append(_from_nchw(z[:, 1:2], batch, 1))
    return Coeffs1D(_from_nchw(a, batch, 1), tuple(details))


@takes_precision
def idwt1d(coeffs: Coeffs1D, wav: Wavelet, length: int, *,
           backend: Optional[str] = None, pad_fn=None,
           mode="periodization") -> jnp.ndarray:
    from .modes import level_sizes as _mode_sizes
    from .modes import per_axis

    (mode,) = per_axis(mode, 1)
    levels = coeffs.levels
    sizes = _mode_sizes(length, levels, wav.hlen, mode)
    rec = (wav.rec_lo, wav.rec_hi)
    a, batch = _to_nchw(coeffs.approx, 1)
    for i in range(levels - 1, -1, -1):
        d, _ = _to_nchw(coeffs.details[i], 1)
        z = jnp.concatenate([a, d], axis=1)
        a = conv.synthesis_pass(z, rec, axis=-1, out_len=sizes[i],
                                backend=backend, pad_fn=pad_fn, mode=mode)
    return _from_nchw(a, batch, 1)


@takes_precision
def iswt2d_denoise(coeffs: Coeffs2D, wav: Wavelet, beta, *,
                   mode: str = "soft", normalize: bool = False,
                   do_thresh_appcoeffs: bool = False,
                   backend: Optional[str] = None) -> jnp.ndarray:
    """Detail threshold followed by the inverse 2D SWT: the same result
    as ops.soft/hard/garrote_threshold then :func:`iswt2d`, as one
    traceable step (XLA fuses the elementwise threshold into the first
    synthesis pass that reads each subband)."""
    from .. import ops as _ops

    fn = {"soft": _ops.soft_threshold, "hard": _ops.hard_threshold,
          "garrote": _ops.garrote_threshold}[mode]
    c2 = fn(coeffs, beta, normalize=normalize,
            do_thresh_appcoeffs=do_thresh_appcoeffs)
    return iswt2d(c2, wav, backend=backend)


@takes_precision
def swt1d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
          backend: Optional[str] = None, pad_fn=None,
          keep_approx: bool = False):
    """Stationary 1D transform; ``keep_approx`` as in :func:`swt2d`."""
    arr, batch = _to_nchw(x, 1)
    dec = (wav.dec_lo, wav.dec_hi)
    details: List[jnp.ndarray] = []
    approxs: List[jnp.ndarray] = []
    a = arr
    for lvl in range(1, levels + 1):
        f = 1 << (lvl - 1)
        z = conv.analysis_pass(a, dec, axis=-1, dilation=f, decimate=False,
                               backend=backend, pad_fn=pad_fn)
        a = z[:, 0:1]
        details.append(_from_nchw(z[:, 1:2], batch, 1))
        if keep_approx:
            approxs.append(_from_nchw(a, batch, 1))
    coeffs = Coeffs1D(_from_nchw(a, batch, 1), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


@takes_precision
def iswt1d(coeffs: Coeffs1D, wav: Wavelet, *,
           backend: Optional[str] = None, pad_fn=None) -> jnp.ndarray:
    # Single pass in 1D -> one 1/2 factor (reference: src/separable.cu:653-672).
    rec = (wav.rec_lo * 0.5, wav.rec_hi * 0.5)
    a, batch = _to_nchw(coeffs.approx, 1)
    for i in range(coeffs.levels - 1, -1, -1):
        f = 1 << i
        d, _ = _to_nchw(coeffs.details[i], 1)
        z = jnp.concatenate([a, d], axis=1)
        a = conv.synthesis_pass(z, rec, axis=-1, dilation=f, decimated=False,
                                backend=backend, pad_fn=pad_fn)
    return _from_nchw(a, batch, 1)
