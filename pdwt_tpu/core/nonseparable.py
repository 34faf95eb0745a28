"""Non-separable 2D DWT / SWT: one true-2D filter per subband.

Functional equivalents of the reference non-separable engine
(reference: src/nonseparable.cu):

* ``dwt2d_ns`` — w_kern_forward (src/nonseparable.cu:114-170): a single
  2D periodic convolution with the four quad filters + 2x2 decimation.
* ``idwt2d_ns`` — w_kern_inverse (src/nonseparable.cu:176-225): the 2D
  polyphase reconstruction, expressed here as zero-stuffing both axes and
  correlating with the reversed quads at the per-axis synthesis shift
  (same algebra as the separable inverse, applied along both axes).
* ``swt2d_ns`` / ``iswt2d_ns`` — w_kern_forward_swt / w_kern_inverse_swt
  (src/nonseparable.cu:304-354, 360-401); the inverse carries the 1/4
  factor (src/nonseparable.cu:393-396).

Quads may be arbitrary user 2D filters (reference:
w_set_filters_forward_nonseparable, src/nonseparable.cu:86-106); for a
named wavelet they are the separable outer products built by
``pdwt_tpu.filters.quad_filters`` (reference: src/nonseparable.cu:32-83).
Unlike the reference — which reloads the inverse quads into the *same*
constant-memory symbols at every inverse() (src/wt.cu:298, a documented
wart, TODO.txt:7) — forward and inverse quads here are independent
constants baked into the jitted program.

Subband convention: by default the quads from ``quad_filters`` follow the
separable engine's (H = highpass along rows); the reference non-separable
engine's swapped H/V can be reproduced via
``quad_filters(..., transpose_detail_convention=True)``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from . import conv
from .separable import Coeffs2D, _from_nchw, _to_nchw
from .shapes import level_sizes
from .precision import takes_precision


def _accum(dtype):
    return jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) else dtype


def _conv2d(x, kernel, *, strides=(1, 1), dilation=(1, 1), fgc=1):
    dtype = x.dtype
    out = lax.conv_general_dilated(
        x,
        jnp.asarray(kernel, dtype=_accum(dtype)),
        window_strides=strides,
        padding="VALID",
        rhs_dilation=dilation,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=fgc,
        precision=(lax.Precision.HIGHEST if dtype == jnp.float32 else None),
        preferred_element_type=_accum(dtype),
    )
    return out.astype(dtype)


def _check_quads(quads) -> np.ndarray:
    q = np.asarray(quads, dtype=np.float64)
    if q.ndim != 3 or q.shape[0] != 4 or q.shape[1] != q.shape[2]:
        raise ValueError(f"quads must have shape (4, hlen, hlen), got {q.shape}")
    return q


def _try_factor(q: np.ndarray):
    """Jointly-separable quad detection (see filters.bank.factor_quads).

    Named wavelets always produce outer-product quads
    (reference: src/nonseparable.cu:16-24 w_outer), so the non-separable
    mode routes through the fast separable passes whenever possible; the
    true-2D convolution only runs for genuinely non-separable user quads.
    """
    from ..filters.bank import factor_quads

    return factor_quads(q)


def _rank_decomp(q: np.ndarray, rtol: float = 1e-12):
    """Joint separable-sum decomposition: Q_s = sum_k outer(a_k^(s), b_k).

    One SVD of the stacked (4*hlen, hlen) matrix yields a COLUMN-filter
    basis ``b_k`` shared by all four quads and per-subband row filters
    ``a_k^(s)``; a genuinely 2D filter of rank r then costs r separable
    pass-sets instead of an hlen^2-tap 2D convolution; structured quads
    (quincunx, directional) typically have rank 2-4.  Returns (A (4, r, hlen),
    B (r, hlen)).  Reference true-2D path: src/nonseparable.cu:114-170.
    """
    four, h, _ = q.shape
    M = q.reshape(4 * h, h)
    U, S, Vt = np.linalg.svd(M, full_matrices=False)
    r = max(1, int(np.sum(S > rtol * S[0])))
    B = Vt[:r]                                          # (r, h) col filters
    A = (U[:, :r] * S[:r]).reshape(4, h, r).transpose(0, 2, 1)
    return A, B


def _fwd_level(x, quads):
    """x: (B,1,H,W); quads: (4,hlen,hlen) forward-convention filters."""
    hlen = quads.shape[-1]
    c = conv.fwd_center(hlen)
    x = conv.odd_extend(conv.odd_extend(x, -1), -2)
    xp = conv.wrap_pad(x, -2, c, hlen - 1 - c)
    xp = conv.wrap_pad(xp, -1, c, hlen - 1 - c)
    kern = quads[:, None, ::-1, ::-1]  # (O=4, I=1, kh, kw), reversed taps
    return _conv2d(xp, kern, strides=(2, 2))


def _inv_level(z, quads, out_shape):
    """z: (B,4,mr,mc) subbands (A,H,V,D); quads: inverse-convention filters."""
    hlen = quads.shape[-1]
    s = conv.inv_shift(hlen)
    u = conv.zero_stuff(conv.zero_stuff(z, -1), -2)
    u = conv.wrap_pad(u, -2, s, hlen - 1 - s)
    u = conv.wrap_pad(u, -1, s, hlen - 1 - s)
    kern = quads[None, :, ::-1, ::-1]  # (O=1, I=4, kh, kw): sum the 4 bands
    out = _conv2d(u, kern)
    out = lax.slice_in_dim(out, 0, out_shape[0], axis=-2)
    out = lax.slice_in_dim(out, 0, out_shape[1], axis=-1)
    return out


@takes_precision
def dwt2d_ns(x: jnp.ndarray, quads, levels: int, *,
             backend=None, pad_fn=None) -> Coeffs2D:
    q = _check_quads(quads)
    fac = _try_factor(q)
    arr, batch = _to_nchw(x, 2)
    details: List[Tuple[jnp.ndarray, ...]] = []
    a = arr
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c = fac
        if np.allclose(lo_r, lo_c) and np.allclose(hi_r, hi_c):
            # isotropic separable: the separable engine
            from ..filters import Wavelet
            from . import separable as sep

            wav = Wavelet("ns-factored", lo_r, hi_r, lo_r, hi_r)
            return sep.dwt2d(x, wav, levels, backend=backend,
                             pad_fn=pad_fn)
        for _ in range(levels):
            t = conv.analysis_pass(a, (lo_c, hi_c), axis=-1, pad_fn=pad_fn)
            z = conv.analysis_pass(t, (lo_r, hi_r), axis=-2, pad_fn=pad_fn)
            a = z[:, 0:1]
            details.append(tuple(
                _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
            ))
        return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))
    A, Bc = _rank_decomp(q)
    for _ in range(levels):
        z = _rank_fwd_level(a, A, Bc, pad_fn)
        a = z[:, 0:1]
        details.append(tuple(
            _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
        ))
    return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))


def _rank_fwd_level(a, A, Bc, pad_fn=None):
    """One decimated level of the rank-r separable-sum (see _rank_decomp):
    one K=r column pass, then r K=4 row passes accumulated."""
    r = Bc.shape[0]
    t = conv.analysis_pass(a, list(Bc), axis=-1,
                           pad_fn=pad_fn)               # (B, r, H, W/2)
    z = None
    for k in range(r):
        w4 = conv.analysis_pass(t[:, k:k + 1], list(A[:, k]), axis=-2,
                                pad_fn=pad_fn)
        z = w4 if z is None else z + w4
    return z


def _rank_inv_level(z, A, Bc, out_shape, pad_fn=None):
    """Inverse of _rank_fwd_level: r K=4 row-synthesis calls (summing the
    subbands), then one K=r column synthesis (summing the rank terms)."""
    r = Bc.shape[0]
    ts = [conv.synthesis_pass(z, list(A[:, k]), axis=-2,
                              out_len=out_shape[0], pad_fn=pad_fn)
          for k in range(r)]
    t = jnp.concatenate(ts, axis=1)                     # (B, r, H, mc)
    return conv.synthesis_pass(t, list(Bc), axis=-1, out_len=out_shape[1],
                               pad_fn=pad_fn)


@takes_precision
def idwt2d_ns(coeffs: Coeffs2D, quads_inv, shape: Tuple[int, int], *,
              backend=None, pad_fn=None) -> jnp.ndarray:
    q = _check_quads(quads_inv)
    fac = _try_factor(q)
    levels = coeffs.levels
    rows = level_sizes(shape[0], levels)
    cols = level_sizes(shape[1], levels)
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c = fac
        if np.allclose(lo_r, lo_c) and np.allclose(hi_r, hi_c):
            from ..filters import Wavelet
            from . import separable as sep

            wav = Wavelet("ns-factored", lo_r, hi_r, lo_r, hi_r)
            return sep.idwt2d(coeffs, wav, shape, backend=backend,
                              pad_fn=pad_fn)
        a, batch = _to_nchw(coeffs.approx, 2)
        for i in range(levels - 1, -1, -1):
            h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
            z = jnp.concatenate([a, h, v, d], axis=1)
            t = conv.synthesis_pass(z, (lo_r, hi_r), axis=-2,
                                    out_len=rows[i], pad_fn=pad_fn)
            a = conv.synthesis_pass(t, (lo_c, hi_c), axis=-1,
                                    out_len=cols[i], pad_fn=pad_fn)
        return _from_nchw(a, batch, 2)
    a, batch = _to_nchw(coeffs.approx, 2)
    A, Bc = _rank_decomp(q)
    for i in range(levels - 1, -1, -1):
        h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
        z = jnp.concatenate([a, h, v, d], axis=1)
        a = _rank_inv_level(z, A, Bc, (rows[i], cols[i]), pad_fn)
    return _from_nchw(a, batch, 2)


def _fwd_swt_level(x, quads, factor):
    hlen = quads.shape[-1]
    c = conv.fwd_center(hlen) * factor
    span = (quads.shape[-1] - 1) * factor
    xp = conv.wrap_pad(x, -2, c, span - c)
    xp = conv.wrap_pad(xp, -1, c, span - c)
    kern = quads[:, None, ::-1, ::-1]
    return _conv2d(xp, kern, dilation=(factor, factor))


def _inv_swt_level(z, quads, factor):
    hlen = quads.shape[-1]
    c = conv.swt_inv_center(hlen) * factor
    span = (hlen - 1) * factor
    u = conv.wrap_pad(z, -2, c, span - c)
    u = conv.wrap_pad(u, -1, c, span - c)
    # 1/4 normalization (reference: src/nonseparable.cu:393-396).
    kern = quads[None, :, ::-1, ::-1] * 0.25
    return _conv2d(u, kern, dilation=(factor, factor))


@takes_precision
def swt2d_ns(x: jnp.ndarray, quads, levels: int, *,
             backend=None, pad_fn=None) -> Coeffs2D:
    q = _check_quads(quads)
    fac = _try_factor(q)
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c = fac
        if np.allclose(lo_r, lo_c) and np.allclose(hi_r, hi_c):
            from ..filters import Wavelet
            from . import separable as sep

            return sep.swt2d(x, Wavelet("ns-factored", lo_r, hi_r,
                                        lo_r, hi_r), levels,
                             backend=backend, pad_fn=pad_fn)
        arr, batch = _to_nchw(x, 2)
        details = []
        a = arr
        for lvl in range(1, levels + 1):
            f = 1 << (lvl - 1)
            t = conv.analysis_pass(a, (lo_c, hi_c), axis=-1, dilation=f,
                                   decimate=False, pad_fn=pad_fn)
            z = conv.analysis_pass(t, (lo_r, hi_r), axis=-2, dilation=f,
                                   decimate=False, pad_fn=pad_fn)
            a = z[:, 0:1]
            details.append(tuple(
                _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
            ))
        return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))
    arr, batch = _to_nchw(x, 2)
    details: List[Tuple[jnp.ndarray, ...]] = []
    a = arr
    A, Bc = _rank_decomp(q)
    for lvl in range(1, levels + 1):
        f = 1 << (lvl - 1)
        t = conv.analysis_pass(a, list(Bc), axis=-1, dilation=f,
                               decimate=False, pad_fn=pad_fn)
        z = None
        for k in range(Bc.shape[0]):
            w4 = conv.analysis_pass(t[:, k:k + 1], list(A[:, k]),
                                    axis=-2, dilation=f,
                                    decimate=False, pad_fn=pad_fn)
            z = w4 if z is None else z + w4
        a = z[:, 0:1]
        details.append(tuple(
            _from_nchw(z[:, k:k + 1], batch, 2) for k in (1, 2, 3)
        ))
    return Coeffs2D(_from_nchw(a, batch, 2), tuple(details))


@takes_precision
def iswt2d_ns(coeffs: Coeffs2D, quads_inv, *, backend=None,
              pad_fn=None) -> jnp.ndarray:
    q = _check_quads(quads_inv)
    fac = _try_factor(q)
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c = fac
        if np.allclose(lo_r, lo_c) and np.allclose(hi_r, hi_c):
            from ..filters import Wavelet
            from . import separable as sep

            return sep.iswt2d(coeffs, Wavelet("ns-factored", lo_r, hi_r,
                                              lo_r, hi_r),
                              backend=backend, pad_fn=pad_fn)
        # 1/4 total = 1/2 per separable pass (src/nonseparable.cu:393-396)
        rec_r = (lo_r * 0.5, hi_r * 0.5)
        rec_c = (lo_c * 0.5, hi_c * 0.5)
        a, batch = _to_nchw(coeffs.approx, 2)
        for i in range(coeffs.levels - 1, -1, -1):
            f = 1 << i
            h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
            z = jnp.concatenate([a, h, v, d], axis=1)
            t = conv.synthesis_pass(z, rec_r, axis=-2, dilation=f,
                                    decimated=False, pad_fn=pad_fn)
            a = conv.synthesis_pass(t, rec_c, axis=-1, dilation=f,
                                    decimated=False, pad_fn=pad_fn)
        return _from_nchw(a, batch, 2)
    a, batch = _to_nchw(coeffs.approx, 2)
    # 1/4 normalization (reference: src/nonseparable.cu:393-396) carried
    # on the shared column basis.
    A, Bc = _rank_decomp(q)
    Bc4 = Bc * 0.25
    for i in range(coeffs.levels - 1, -1, -1):
        f = 1 << i
        h, v, d = (_to_nchw(c, 2)[0] for c in coeffs.details[i])
        z = jnp.concatenate([a, h, v, d], axis=1)
        ts = [conv.synthesis_pass(z, list(A[:, k]), axis=-2,
                                  dilation=f, decimated=False,
                                  pad_fn=pad_fn)
              for k in range(A.shape[1])]
        t = jnp.concatenate(ts, axis=1)
        a = conv.synthesis_pass(t, list(Bc4), axis=-1, dilation=f,
                                decimated=False, pad_fn=pad_fn)
    return _from_nchw(a, batch, 2)
