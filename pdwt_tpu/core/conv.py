"""Periodic filtering primitives — the compute core of the framework.

This module defines the exact index semantics of the transforms, derived
from the reference CUDA kernels but re-cast as gather/convolution algebra
that XLA compiles for the device:

Forward decimated analysis (reference: src/separable.cu:91-131):
    c  = hlen//2 if hlen odd else hlen//2 - 1      (even taps: center left)
    xe = x extended by repeating the last element when N is odd
         ("virtual extension", reference: src/separable.cu:116-121)
    out[n] = sum_j  filt[hlen-1-j] * xe[(2n - c + j) mod Ne],  n in [0, Ne/2)

Inverse decimated synthesis (reference: src/separable.cu:246-328).  The
reference's polyphase even/odd tap selection with the "virtual index"
shift for even half-length is algebraically identical to correlating the
zero-stuffed upsampled coefficients with the reversed synthesis filter at
a fixed shift s:
    h2 = hlen//2 ; c2 = h2//2 ; s = 2*c2+1 if h2 odd else 2*c2
    u[2t] = a[t], u[2t+1] = 0                     (length 2M)
    out[g] = sum_j rec[hlen-1-j] * u[(g - s + j) mod 2M],  sliced to out_len

SWT (a-trous, reference: src/separable.cu:409-493, 553-626): stride 1,
filter dilated by factor = 2^(level-1); analysis centers like the forward
pass scaled by factor; synthesis uses c = hlen//2 (both parities,
reference: src/separable.cu:559-568) scaled by factor, and halves the taps
per pass (reference: src/separable.cu:581-584).

Everything operates on NCHW arrays.  Three interchangeable backends:

* ``fma``   — polyphase decomposition into contiguous slices + tap-by-tap
              FMA.  A wavelet filter pass is a short FIR over a huge
              array; this formulation never forms windows: decimation
              becomes an even/odd parity split (contiguous slices), and
              the inverse's zero-stuffed polyphase becomes per-parity
              half-filters recombined by interleaving.
* ``xla``   — periodic padding + ``lax.conv_general_dilated`` (a C=1
              grouped convolution that XLA hands to its conv library).
* ``gather`` — take()-based windows + tensordot; shape-agnostic oracle used
              for cross-checking.

Which of ``fma`` and ``xla`` runs when no backend is named is decided per
platform in one place, :func:`default_formulation`.

All produce bit-identical index semantics; tests assert their equality.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_BACKENDS = ("fma", "xla", "gather")

# Formulation of the filter passes when no backend is named, per JAX
# platform.  cpu: XLA's CPU conv lowers well and the unrolled fma graphs
# compile slowly there.  gpu: fma, 2.3-5.4x faster than xla end to end
# on an H100 (chip_smoke.py --ab; the timings are in CHANGES.md).
_PLATFORM_DEFAULT = {"cpu": "xla", "gpu": "fma"}

# An explicit override: the PDWT_TPU_BACKEND env var or
# set_default_backend().  Validated where it is used.
_default_backend: Optional[str] = (
    __import__("os").environ.get("PDWT_TPU_BACKEND") or None
)


def _check_backend(name: str) -> str:
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {_BACKENDS}")
    return name


def set_default_backend(name: Optional[str]) -> None:
    global _default_backend
    if name is not None:
        _check_backend(name)
    _default_backend = name


def default_formulation(platform: str) -> str:
    """The formulation a platform runs when no backend is named."""
    try:
        return _PLATFORM_DEFAULT[platform]
    except KeyError:
        raise ValueError(
            f"no default wavelet formulation for JAX platform {platform!r}; "
            f"supported platforms: {sorted(_PLATFORM_DEFAULT)}") from None


def get_default_backend() -> str:
    """Backend for conv passes that name none: the override if set, else
    :func:`default_formulation` of the running platform."""
    if _default_backend is not None:
        return _check_backend(_default_backend)
    return default_formulation(jax.default_backend())


def resolve_backend(backend: Optional[str]) -> str:
    """Validate an explicit backend, or pick the default one."""
    return get_default_backend() if backend is None else _check_backend(
        backend)


def fwd_center(hlen: int) -> int:
    """Analysis center tap (reference: src/separable.cu:98-107)."""
    return hlen // 2 if hlen % 2 else hlen // 2 - 1


def inv_shift(hlen: int) -> int:
    """Synthesis shift in the upsampled domain (see module docstring)."""
    h2 = hlen // 2
    c2 = h2 // 2
    return 2 * c2 + 1 if h2 % 2 else 2 * c2


def swt_inv_center(hlen: int) -> int:
    """SWT synthesis center (reference: src/separable.cu:559-568)."""
    return hlen // 2


def _accum_dtype(dtype) -> jnp.dtype:
    if dtype in (jnp.bfloat16, jnp.float16):
        return jnp.float32
    return dtype


def _precision(dtype):
    # Full-precision multiplies: a wavelet library must reconstruct to
    # float32 roundoff, which a default-precision (TF32 or bf16-pass)
    # product misses.
    if dtype == jnp.float32:
        return lax.Precision.HIGHEST
    return None


def odd_extend(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Repeat the last element when the size is odd (virtual extension,
    reference: src/separable.cu:116-121)."""
    n = x.shape[axis]
    if n % 2 == 0:
        return x
    last = lax.slice_in_dim(x, n - 1, n, axis=axis)
    return jnp.concatenate([x, last], axis=axis)


def wrap_pad(x: jnp.ndarray, axis: int, lo: int, hi: int) -> jnp.ndarray:
    """Periodic padding, robust to pad widths exceeding the axis size."""
    n = x.shape[axis]
    if lo == 0 and hi == 0:
        return x
    parts = []
    if lo:
        full, rem = divmod(lo, n)
        if rem:
            parts.append(lax.slice_in_dim(x, n - rem, n, axis=axis))
        parts.extend([x] * full)
    parts.append(x)
    if hi:
        full, rem = divmod(hi, n)
        parts.extend([x] * full)
        if rem:
            parts.append(lax.slice_in_dim(x, 0, rem, axis=axis))
    return jnp.concatenate(parts, axis=axis)


def zero_stuff(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Interleave zeros: [a0, a1, ...] -> [a0, 0, a1, 0, ...] (2x length)."""
    axis = axis % x.ndim
    z = jnp.zeros_like(x)
    y = jnp.stack([x, z], axis=axis + 1)
    new_shape = x.shape[:axis] + (2 * x.shape[axis],) + x.shape[axis + 1 :]
    return y.reshape(new_shape)


def _kernel_nd(taps: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """Reshape (O, I, hlen) 1D taps into an OI+spatial kernel with the
    taps along spatial ``axis`` of an (N, C, *spatial) array."""
    o, i, hlen = taps.shape
    shape = [o, i] + [1] * (ndim - 2)
    shape[axis % ndim] = hlen
    return taps.reshape(shape)


_CONV_DIMS = {2: ("NCHW", "OIHW", "NCHW"),
              3: ("NCDHW", "OIDHW", "NCDHW")}


def _conv_nchw(
    x: jnp.ndarray,
    kernel: np.ndarray,
    *,
    window_strides,
    rhs_dilation,
    feature_group_count: int,
) -> jnp.ndarray:
    dtype = x.dtype
    out = lax.conv_general_dilated(
        x.astype(_accum_dtype(dtype)),
        jnp.asarray(kernel, dtype=_accum_dtype(dtype)),
        window_strides=window_strides,
        padding="VALID",
        rhs_dilation=rhs_dilation,
        dimension_numbers=_CONV_DIMS[x.ndim - 2],
        feature_group_count=feature_group_count,
        precision=_precision(dtype),
        preferred_element_type=_accum_dtype(dtype),
    )
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# fma backend: polyphase slice-FMA
# ---------------------------------------------------------------------------

def _fma_analysis(xp, taps, axis, *, decimate, dilation):
    """Correlate padded ``xp`` (B,C,H,W) with every row of ``taps``
    (K, hlen, pre-reversed) along ``axis`` as a sum of contiguous slices
    scaled by scalar taps.  Decimation by 2 becomes an even/odd parity
    split so every slice stays unit-stride.  Returns (B, C*K, ...)."""
    k, hlen = taps.shape
    ax = axis % xp.ndim
    n_pad = xp.shape[ax]
    span = (hlen - 1) * dilation
    stride = 2 if decimate else 1
    n_out = (n_pad - span - 1) // stride + 1
    acc_dt = _accum_dtype(xp.dtype)
    xa = xp.astype(acc_dt)

    if decimate:
        even = lax.slice_in_dim(xa, 0, n_pad, stride=2, axis=ax)
        odd = lax.slice_in_dim(xa, 1, n_pad, stride=2, axis=ax)

        def term(j):
            src, a = (even, j // 2) if j % 2 == 0 else (odd, j // 2)
            return lax.slice_in_dim(src, a, a + n_out, axis=ax)
    else:

        def term(j):
            return lax.slice_in_dim(xa, j * dilation, j * dilation + n_out,
                                    axis=ax)

    outs = []
    for kk in range(k):
        acc = float(taps[kk, 0]) * term(0)
        for j in range(1, hlen):
            acc = acc + float(taps[kk, j]) * term(j)
        outs.append(acc)
    out = jnp.stack(outs, axis=2)  # (B, C, K, ...)
    b, c = out.shape[0], out.shape[1]
    return out.reshape((b, c * k) + out.shape[3:]).astype(xp.dtype)


def _fma_synthesis_poly(x, taps, axis, *, pad_fn, s=None):
    """Decimated synthesis WITHOUT materializing the zero-stuffed array.

    Output parity q of out[g] = sum_j t[j] * u[g - s + j] (u = zero-stuffed
    coeffs) only touches taps j = 2b + p_q with p_q = (s - q) mod 2, at
    coefficient index m + b + o_q, o_q = (q - s + p_q) / 2.  Each parity is
    therefore a plain half-length FIR over the *unstuffed* coefficients —
    half the FLOPs and half the memory traffic of the stuffed form, and
    distributed halos stay in the (small) coefficient domain.  The two
    parities interleave to the final axis.

    ``s`` overrides the synthesis shift: the periodization default is
    :func:`inv_shift`; the pywt non-periodization inverse uses ``s=1``
    with zero padding (see core/modes.py).
    """
    k, hlen = taps.shape
    ax = axis % x.ndim
    m = x.shape[ax]
    if s is None:
        s = inv_shift(hlen)
    p = (s % 2, 1 - s % 2)
    o = (-(s // 2), (1 - s + (1 - s % 2)) // 2)
    nb = tuple(len(range(p[q], hlen, 2)) for q in (0, 1))
    lo = max(0, -min(o))
    hi = max(0, max(o[q] + nb[q] - 1 for q in (0, 1)))
    ap = pad_fn(x, axis, lo, hi).astype(_accum_dtype(x.dtype))

    outs = []
    for q in (0, 1):
        acc = None
        for kk in range(k):
            src = lax.slice_in_dim(ap, kk, ap.shape[1], stride=k, axis=1)
            for b, j in enumerate(range(p[q], hlen, 2)):
                start = lo + o[q] + b
                sl = lax.slice_in_dim(src, start, start + m, axis=ax)
                t = float(taps[kk, j])
                acc = t * sl if acc is None else acc + t * sl
        outs.append(acc)
    y = jnp.stack(outs, axis=ax + 1)
    shape = outs[0].shape[:ax] + (2 * m,) + outs[0].shape[ax + 1 :]
    return y.reshape(shape).astype(x.dtype)


def _fma_synthesis(up, taps, axis, *, dilation):
    """Synthesis combination: input (B, C*K, ...) padded (and, for the
    decimated inverse, zero-stuffed); output channel c sums the K filter
    correlations of its group.  Pure slice-FMA like the analysis."""
    k, hlen = taps.shape
    ax = axis % up.ndim
    n_pad = up.shape[ax]
    n_out = n_pad - (hlen - 1) * dilation
    acc_dt = _accum_dtype(up.dtype)
    ua = up.astype(acc_dt)

    acc = None
    for kk in range(k):
        # channels kk, K+kk, 2K+kk, ... — one strided channel slice
        src = lax.slice_in_dim(ua, kk, ua.shape[1], stride=k, axis=1)
        for j in range(hlen):
            sl = lax.slice_in_dim(src, j * dilation, j * dilation + n_out,
                                  axis=ax)
            t = float(taps[kk, j])
            acc = t * sl if acc is None else acc + t * sl
    return acc.astype(up.dtype)


# ---------------------------------------------------------------------------
# Analysis (forward) pass along one axis
# ---------------------------------------------------------------------------

def analysis_pass(
    x: jnp.ndarray,
    filters: Sequence[np.ndarray],
    axis: int,
    *,
    dilation: int = 1,
    decimate: bool = True,
    backend: Optional[str] = None,
    pad_fn=None,
    mode: str = "periodization",
) -> jnp.ndarray:
    """Filter every channel of ``x`` (B,C,H,W) with each 1D filter along
    ``axis``, optionally decimating by 2.

    Returns (B, C*K, H', W') with output channel c*K + k = filter k applied
    to input channel c.  ``filters`` are the *forward-convention* taps
    (e.g. dec_lo); the reversal for correlation happens here.

    ``pad_fn(x, axis, lo, hi)`` overrides the periodic padding — the
    distributed engine substitutes a ring halo exchange here so the
    same pass runs on spatially sharded arrays (see pdwt_tpu.parallel).

    ``mode`` selects the boundary extension (core/modes.py).  The default
    ``"periodization"`` is the reference scheme (odd-size virtual
    extension + periodic wrap, ceil(N/2) outputs); every other pywt mode
    applies to the decimated DWT only and yields floor((N+hlen-1)/2)
    outputs per pywt's convolution semantics.
    """
    backend = resolve_backend(backend)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    assert all(len(f) == hlen for f in filters)
    taps = np.stack([f[::-1] for f in filters])  # (K, hlen)

    if mode != "periodization":
        from . import modes as _modes

        _modes.check_mode(mode)
        if not decimate or dilation != 1:
            raise ValueError(
                "boundary modes other than 'periodization' apply to the "
                "decimated DWT only (pywt's swt is periodic by definition)")
        if pad_fn is not None:
            raise ValueError(
                "sharded halo exchange (pad_fn) requires mode='periodization'")
        # out[m] = sum_j f[j] x_ext[2m+1-j]  (pywt downsampling_convolution)
        # == valid correlation of reversed taps over x extended by
        # (hlen-2, hlen-1); n_out = floor((N+hlen-1)/2) falls out.
        xp = _modes.extend(x, axis, hlen - 2, hlen - 1, mode)
    else:
        pad_fn = pad_fn or wrap_pad
        c = fwd_center(hlen) * dilation
        pad_hi = (hlen - 1) * dilation - c
        if decimate:
            assert dilation == 1
            x = odd_extend(x, axis)
        xp = pad_fn(x, axis, c, pad_hi)

    k = len(filters)
    ch = x.shape[1]
    if backend == "fma":
        return _fma_analysis(xp, taps, axis, decimate=decimate,
                             dilation=dilation)
    if backend == "xla":
        kern = _kernel_nd(
            np.broadcast_to(taps[None], (ch, k, hlen)).reshape(ch * k, 1, hlen),
            axis, xp.ndim,
        )
        sr = xp.ndim - 2
        strides = [1] * sr
        dil = [1] * sr
        axp = (axis % xp.ndim) - 2
        strides[axp] = 2 if decimate else 1
        dil[axp] = dilation
        return _conv_nchw(
            xp, kern, window_strides=tuple(strides), rhs_dilation=tuple(dil),
            feature_group_count=ch,
        )
    elif backend == "gather":
        return _gather_corr(xp, taps, axis, stride=2 if decimate else 1,
                            dilation=dilation, split_channels=True)
    raise ValueError(f"unknown backend {backend!r}")


# ---------------------------------------------------------------------------
# Synthesis (inverse) pass along one axis
# ---------------------------------------------------------------------------

def synthesis_pass(
    x: jnp.ndarray,
    filters: Sequence[np.ndarray],
    axis: int,
    *,
    out_len: Optional[int] = None,
    dilation: int = 1,
    decimated: bool = True,
    backend: Optional[str] = None,
    pad_fn=None,
    mode: str = "periodization",
) -> jnp.ndarray:
    """Synthesis: input (B, C*K, H, W) where each group of K consecutive
    channels is combined into one output channel:
        out[:, c] = sum_k corr(upsample(x[:, c*K+k]), reversed(filters[k]))

    ``decimated=True`` zero-stuffs along ``axis`` and slices to ``out_len``
    (DWT inverse); ``decimated=False`` is the a-trous SWT inverse (caller
    pre-scales the filters by the per-pass 1/2, reference:
    src/separable.cu:581-584).

    ``pad_fn`` — see :func:`analysis_pass`; applied to the (zero-stuffed)
    upsampled array.

    ``mode`` — boundary extension of the matching forward pass.  Modes
    other than ``"periodization"`` follow pywt's inverse: NO boundary
    extension (a valid correlation of the zero-stuffed coefficients,
    shift s=1), full output length ``2M - hlen + 2``, sliced to
    ``out_len``.  Requires an even filter length, as pywt does.
    """
    backend = resolve_backend(backend)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    k = len(filters)
    taps = np.stack([f[::-1] for f in filters])  # (K, hlen)

    s_override = None
    if mode != "periodization":
        from . import modes as _modes

        _modes.check_mode(mode)
        if not decimated or dilation != 1:
            raise ValueError(
                "boundary modes other than 'periodization' apply to the "
                "decimated inverse DWT only")
        if pad_fn is not None:
            raise ValueError(
                "sharded halo exchange (pad_fn) requires mode='periodization'")
        if hlen % 2:
            raise ValueError(
                "non-periodization inverse requires an even filter length "
                "(pywt upsampling_convolution_valid_sf parity)")
        full = _modes.rec_len(x.shape[axis % x.ndim], hlen, mode)
        if out_len is None:
            out_len = full
        elif out_len > full:
            raise ValueError(
                f"out_len {out_len} exceeds the mode's full inverse length "
                f"{full}")
        pad_fn = _modes.zero_pad
        s_override = 1
    else:
        pad_fn = pad_fn or wrap_pad

    if backend == "fma" and decimated:
        assert dilation == 1
        out = _fma_synthesis_poly(x, taps, axis, pad_fn=pad_fn, s=s_override)
        if out_len is not None:
            out = lax.slice_in_dim(out, 0, out_len, axis=axis)
        return out

    if decimated:
        assert dilation == 1
        s = inv_shift(hlen) if s_override is None else s_override
        u = zero_stuff(x, axis)
    else:
        s = swt_inv_center(hlen) * dilation
        u = x
    pad_hi = (hlen - 1) * dilation - s
    up = pad_fn(u, axis, s, pad_hi)

    ch_out = x.shape[1] // k
    if backend == "fma":
        out = _fma_synthesis(up, taps, axis, dilation=dilation)
    elif backend == "xla":
        kern = _kernel_nd(
            np.broadcast_to(taps[None], (ch_out, k, hlen)).reshape(ch_out, k, hlen)
            [:, :, :],
            axis, up.ndim,
        )
        sr = up.ndim - 2
        dil = [1] * sr
        dil[(axis % up.ndim) - 2] = dilation
        out = _conv_nchw(
            up, kern, window_strides=(1,) * sr, rhs_dilation=tuple(dil),
            feature_group_count=ch_out,
        )
    elif backend == "gather":
        # _gather_corr applies every tap to every channel; synthesis needs
        # channel g*K+k correlated with taps[k] only -> take the (k,k)
        # diagonal and sum within each group.
        corr = _gather_corr(up, taps, axis, stride=1, dilation=dilation,
                            split_channels=True)
        b = corr.shape[0]
        sp = corr.shape[2:]
        out = jnp.einsum("bgkk...->bg...",
                         corr.reshape((b, ch_out, k, k) + sp))
    else:
        raise ValueError(f"unknown backend {backend!r}")

    if out_len is not None:
        out = lax.slice_in_dim(out, 0, out_len, axis=axis)
    return out


# ---------------------------------------------------------------------------
# Gather backend (oracle)
# ---------------------------------------------------------------------------

def _gather_corr(xp, taps, axis, *, stride, dilation, split_channels):
    """Valid correlation via window gather + tensordot.  ``xp`` is already
    padded; ``taps`` is (K, hlen) pre-reversed."""
    k, hlen = taps.shape
    ax = axis % xp.ndim
    n_pad = xp.shape[ax]
    span = (hlen - 1) * dilation
    n_out = (n_pad - span - 1) // stride + 1
    idx = (stride * np.arange(n_out)[:, None] + dilation * np.arange(hlen)[None, :])
    win = jnp.take(xp, jnp.asarray(idx.reshape(-1)), axis=ax)
    new_shape = xp.shape[:ax] + (n_out, hlen) + xp.shape[ax + 1 :]
    win = win.reshape(new_shape)
    t = jnp.asarray(taps.T, dtype=_accum_dtype(xp.dtype))  # (hlen, K)
    out = jnp.tensordot(win.astype(_accum_dtype(xp.dtype)), t,
                        axes=[[ax + 1], [0]],
                        precision=lax.Precision.HIGHEST)
    # out shape: xp.shape[:ax] + (n_out,) + xp.shape[ax+1:] + (K,)
    out = jnp.moveaxis(out, -1, 2)  # (B, C, K, ...) -> then merge C*K
    b, c, kk = out.shape[0], out.shape[1], out.shape[2]
    out = out.reshape((b, c * kk) + out.shape[3:])
    return out.astype(xp.dtype)
