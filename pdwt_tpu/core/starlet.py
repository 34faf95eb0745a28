"""Starlet (isotropic undecimated à-trous) transform, 1D/2D/3D.

The astronomy workhorse (Starck, Murtagh & Fadili, "Sparse Image and
Signal Processing"): smooth with the B3-spline kernel
``[1, 4, 6, 4, 1] / 16`` dilated à-trous per level, and keep the
full-resolution differences as the detail planes:

    a_j = h_{2^(j-1)} * a_{j-1}          (separable, per axis)
    w_j = a_{j-1} - a_j                  (first generation), or
    w_j = a_{j-1} - h * a_j              (second generation)

Reconstruction is exact by construction: gen-1 telescopes to
``x = a_J + sum_j w_j``; gen-2 inverts level-by-level as
``a_{j-1} = h * a_j + w_j`` (the positivity-friendly variant whose
synthesis lowpass suppresses thresholding artifacts).

Beyond the reference: PDWT has no isotropic transform (its SWT is the
separable Mallat à-trous with 3 oriented bands per 2D level,
reference: src/separable.cu:409-493).  The starlet's single isotropic
detail plane per scale is what astronomy/biomedical denoising and
deconvolution pipelines expect.

Every pass is the lowpass-only :func:`conv.analysis_pass` (K=1), so
the whole transform is jit/vmap/grad-friendly, rides all backends, and
takes ``pad_fn`` for sharded halo rings.  The index semantics are
core/conv.py's (periodic, centered).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from . import conv

#: the cubic B3-spline smoothing kernel (Starck et al. eq. 1.13)
B3_SPLINE = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


class StarletCoeffs(NamedTuple):
    """``details[j]`` is the full-resolution detail plane of scale
    ``j+1`` (finest first); ``approx`` is the coarsest smooth."""
    approx: jnp.ndarray
    details: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def _to_nc(x: jnp.ndarray, sd: int):
    batch = x.shape[:-sd]
    b = int(np.prod(batch, dtype=np.int64)) if batch else 1
    if sd == 1:  # conv backends want >= 2 spatial dims: dummy row axis
        return x.reshape((b, 1, 1) + x.shape[-1:]), batch
    return x.reshape((b, 1) + x.shape[-sd:]), batch


def _smooth(a: jnp.ndarray, sd: int, dilation: int, backend, pad_fn):
    """One B3 smoothing: the dilated lowpass along each of the ``sd``
    trailing spatial axes (axes of the (B, C, ...) layout)."""
    for ax in range(-sd, 0):
        a = conv.analysis_pass(a, (B3_SPLINE,), axis=ax,
                               dilation=dilation, decimate=False,
                               backend=backend, pad_fn=pad_fn)
    return a


def starlet(x: jnp.ndarray, levels: int, *, ndim: int = 2, gen: int = 2,
            backend: Optional[str] = None, pad_fn=None) -> StarletCoeffs:
    """Isotropic à-trous decomposition over the trailing ``ndim`` axes
    (leading axes are batch).  ``gen`` selects the detail definition
    (1: ``a_{j-1} - a_j``; 2: ``a_{j-1} - h*a_j``, the default)."""
    if gen not in (1, 2):
        raise ValueError(f"gen must be 1 or 2, got {gen}")
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
    arr, batch = _to_nc(x, ndim)
    details = []
    a = arr
    for j in range(levels):
        nxt = _smooth(a, ndim, 1 << j, backend, pad_fn)
        ref = nxt if gen == 1 else _smooth(nxt, ndim, 1 << j, backend,
                                           pad_fn)
        details.append((a - ref).reshape(batch + x.shape[-ndim:]))
        a = nxt
    return StarletCoeffs(a.reshape(batch + x.shape[-ndim:]),
                         tuple(details))


def istarlet(coeffs: StarletCoeffs, *, ndim: int = 2, gen: int = 2,
             backend: Optional[str] = None, pad_fn=None) -> jnp.ndarray:
    """Exact inverse of :func:`starlet` (same ``gen``/``ndim``)."""
    if gen == 1:
        out = coeffs.approx
        for w in coeffs.details:
            out = out + w
        return out
    a, batch = _to_nc(coeffs.approx, ndim)
    spatial = coeffs.approx.shape[-ndim:]
    for j in range(len(coeffs.details) - 1, -1, -1):
        w, _ = _to_nc(coeffs.details[j], ndim)
        a = _smooth(a, ndim, 1 << j, backend, pad_fn) + w
    return a.reshape(batch + spatial)


@functools.lru_cache(maxsize=None)
def starlet_noise_gains(levels: int, ndim: int = 2,
                        gen: int = 2) -> Tuple[float, ...]:
    """L2 norm of each detail plane's equivalent filter — the factor
    mapping white-noise sigma to the per-scale detail sigma (the
    sigma_j table of Starck et al. §6.3, computed exactly for any
    levels/ndim/gen instead of tabulated).

    The scale-j ND detail kernel is the separable difference
    ``K_{j-1}^{(x)ndim} - R_j^{(x)ndim}`` (R = K_j for gen 1,
    h_j * K_j for gen 2), whose norm follows from 1D inner products:
    ``||A - B||^2 = <K,K>^n + <R,R>^n - 2 <K,R>^n``."""
    K = np.array([1.0])
    gains = []
    for j in range(levels):
        h = np.zeros(4 * (1 << j) + 1)
        h[:: 1 << j] = B3_SPLINE
        nxt = np.convolve(K, h)
        ref = nxt if gen == 1 else np.convolve(nxt, h)
        pad = (len(ref) - len(K)) // 2  # both odd, centered
        Kp = np.pad(K, pad)
        kk, rr, kr = Kp @ Kp, ref @ ref, Kp @ ref
        gains.append(float(np.sqrt(kk ** ndim + rr ** ndim
                                   - 2 * kr ** ndim)))
        K = nxt
    return tuple(gains)


def starlet_denoise(x: jnp.ndarray, levels: int, beta, *,
                    mode: str = "soft", ndim: int = 2, gen: int = 2,
                    backend: Optional[str] = None) -> jnp.ndarray:
    """Threshold the starlet detail planes and reconstruct — the
    standard astronomy denoise (isotropic planes avoid the oriented
    artifacts of separable SWT thresholding).  ``beta`` is a scalar or
    a per-level sequence (finest first)."""
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    c = starlet(x, levels, ndim=ndim, gen=gen, backend=backend)
    betas = (list(beta) if isinstance(beta, (list, tuple))
             else [beta] * levels)
    if len(betas) != levels:
        raise ValueError(f"need {levels} betas, got {len(betas)}")
    details = tuple(thr(w, b) for w, b in zip(c.details, betas))
    return istarlet(StarletCoeffs(c.approx, details), ndim=ndim, gen=gen,
                    backend=backend)
