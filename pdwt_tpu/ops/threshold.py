"""Proximal / thresholding operators on coefficient pytrees.

Functional equivalents of the reference threshold kernels + per-level host
loops (reference: src/common.cu:13-198, 219-371).  Where the reference
launches one CUDA kernel per subband per level, here the whole coefficient
pytree is transformed in a single jitted program — XLA fuses everything
into a few elementwise device kernels with no host round-trips.

Semantics notes (all mirrored from the reference):

* ``normalize``: beta is divided by sqrt(2) per level starting at level 1
  (reference: src/common.cu:244), and the approximation threshold uses
  beta / sqrt(2)^nlevels (reference: src/common.cu:231-234).
* group (lasso) soft threshold: per-pixel joint L2 norm over (H, V, D),
  including A only at the coarsest level when ``do_thresh_appcoeffs``
  (reference: src/common.cu:145-198, 331-341).
* ``shrink``: L2 proximal, scale by 1/(1+beta)
  (reference: src/common.cu:347-371); appcoeffs default True
  (reference: src/wt.h:62).
* known reference discrepancy: hard_threshold computes the normalized
  app-coefficient threshold ``beta2`` but then passes the *unnormalized*
  beta to the kernel (reference: src/common.cu:262-270).  We apply
  ``beta2`` — the evidently intended behavior.
"""
from __future__ import annotations

import math
from typing import Union

import jax.numpy as jnp

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D

_SQRT2 = math.sqrt(2.0)

Coeffs = Union[Coeffs1D, Coeffs2D, Coeffs3D]


def _app_beta(beta, nlevels: int, normalize: bool):
    """beta / sqrt(2)^nlevels (reference: src/common.cu:231-234).
    A per-level sequence beta contributes its coarsest-level entry
    (first band's, if per-band) — already level-scaled by construction."""
    if isinstance(beta, (list, tuple)):
        b = beta[-1]
        return b[0] if isinstance(b, (list, tuple)) else b
    if not normalize:
        return beta
    return beta / (2 ** (nlevels // 2)) / (_SQRT2 if nlevels % 2 else 1.0)


def _soft(x, b):
    b = jnp.asarray(b, x.dtype)
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - b, 0)


def _hard(x, b):
    b = jnp.asarray(b, x.dtype)
    return jnp.where(jnp.abs(x) > b, x, 0)


def _clip_linf(x, b):
    b = jnp.asarray(b, x.dtype)
    return jnp.sign(x) * jnp.minimum(jnp.abs(x), b)


def _garrote(x, b):
    # non-negative garrote: x * max(1 - (b/x)^2, 0); continuous, less
    # biased than soft for large |x|, no hard-threshold discontinuity
    b = jnp.asarray(b, x.dtype)
    x2 = x * x
    return jnp.where(x2 > b * b, x - b * b / jnp.where(x == 0, 1, x), 0)


def _firm(x, b1, b2):
    # firm (semisoft): 0 below b1, linear ramp to identity at b2, x above
    b1 = jnp.asarray(b1, x.dtype)
    b2 = jnp.asarray(b2, x.dtype)
    ax = jnp.abs(x)
    ramp = jnp.sign(x) * b2 * (ax - b1) / (b2 - b1)
    return jnp.where(ax <= b1, 0, jnp.where(ax >= b2, x, ramp))


# elementwise forms of the modes the fused threshold-in-inverse kernels
# support — shared by the kernel callers and the packet facades
THR_ELEM = {"soft": _soft, "hard": _hard, "garrote": _garrote}


def _resolve_beta(beta, i: int, j, normalize: bool):
    """Per-(level, band) threshold.  ``beta`` is a scalar (optionally
    sqrt(2)-normalized per level, reference: src/common.cu:244) or a
    per-level sequence — whose elements may themselves be per-band
    sequences, as produced by :func:`pdwt_tpu.ops.bayes_thresholds`
    (normalize is ignored for sequences: they are already per-level)."""
    if isinstance(beta, (list, tuple)):
        b = beta[i]
        if isinstance(b, (list, tuple)):
            b = b[0 if j is None else j]
        return b
    return beta / (_SQRT2 ** (i + 1)) if normalize else beta


def _map_details(coeffs: Coeffs, fn_per_level):
    new_details = []
    for i, det in enumerate(coeffs.details):
        if isinstance(det, tuple):  # 2D (H,V,D) / 3D 7-band levels
            new_details.append(tuple(fn_per_level(arr, i, j)
                                     for j, arr in enumerate(det)))
        else:  # 1D: one detail array per level
            new_details.append(fn_per_level(det, i, None))
    return type(coeffs)(coeffs.approx, tuple(new_details))


def soft_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise soft threshold (L1 proximal), reference:
    src/common.cu:219-249.  ``beta`` may be a per-level (or per-level
    per-band) sequence — see :func:`_resolve_beta`."""
    n = coeffs.levels
    out = _map_details(
        coeffs,
        lambda x, i, j: _soft(x, _resolve_beta(beta, i, j, normalize)),
    )
    if do_thresh_appcoeffs:
        out = type(coeffs)(_soft(coeffs.approx, _app_beta(beta, n, normalize)),
                           out.details)
    return out


def hard_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise hard threshold, reference: src/common.cu:252-282.
    ``beta`` may be a per-level/per-band sequence like soft_threshold's."""
    n = coeffs.levels
    out = _map_details(
        coeffs,
        lambda x, i, j: _hard(x, _resolve_beta(beta, i, j, normalize)),
    )
    if do_thresh_appcoeffs:
        out = type(coeffs)(_hard(coeffs.approx, _app_beta(beta, n, normalize)),
                           out.details)
    return out


def proj_linf(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = True) -> Coeffs:
    """Projection onto the L-infinity ball of radius beta, reference:
    src/common.cu:285-308 (appcoeffs default True per src/wt.h:63)."""
    out = _map_details(coeffs, lambda x, i, j: _clip_linf(x, beta))
    if do_thresh_appcoeffs:
        out = type(coeffs)(_clip_linf(coeffs.approx, beta), out.details)
    return out


def group_soft_threshold(coeffs: Coeffs, beta, *,
                         do_thresh_appcoeffs: bool = False,
                         normalize: bool = False) -> Coeffs:
    """Group-lasso soft threshold: per-pixel joint L2 shrinkage over the
    detail subbands (+ A at the coarsest level), reference:
    src/common.cu:145-198, 311-341."""
    n = coeffs.levels
    new_details = []
    new_approx = coeffs.approx
    for i, det in enumerate(coeffs.details):
        b = beta / (_SQRT2 ** (i + 1)) if normalize else beta
        last = i == n - 1
        include_a = do_thresh_appcoeffs and last
        bands = det if isinstance(det, tuple) else (det,)
        norm2 = sum(x * x for x in bands)
        if include_a:
            norm2 = norm2 + coeffs.approx * coeffs.approx
        norm = jnp.sqrt(norm2)
        fac = jnp.where(norm > 0,
                        jnp.maximum(1 - jnp.asarray(b, norm.dtype) / norm, 0), 0)
        if isinstance(det, tuple):
            new_details.append(tuple(x * fac for x in bands))
        else:
            new_details.append(det * fac)
        if include_a:
            new_approx = coeffs.approx * fac
    return type(coeffs)(new_approx, tuple(new_details))


def garrote_threshold(coeffs: Coeffs, beta, *,
                      do_thresh_appcoeffs: bool = False,
                      normalize: bool = False) -> Coeffs:
    """Non-negative garrote threshold (Gao 1998): x·max(1−β²/x², 0).

    Continuous like soft, but asymptotically unbiased like hard —
    usually the better denoiser of the three at the same β.  One of the
    "more threshold types" the reference wish-list asks for
    (reference: TODO.txt "More threshold types"); shares the
    ``normalize`` / ``do_thresh_appcoeffs`` semantics of
    :func:`soft_threshold`, and accepts per-level/per-band β sequences.
    """
    n = coeffs.levels
    out = _map_details(
        coeffs,
        lambda x, i, j: _garrote(x, _resolve_beta(beta, i, j, normalize)),
    )
    if do_thresh_appcoeffs:
        out = type(coeffs)(
            _garrote(coeffs.approx, _app_beta(beta, n, normalize)),
            out.details)
    return out


def firm_threshold(coeffs: Coeffs, beta, beta2, *,
                   do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Firm (semisoft) threshold (Gao & Bruce 1997): zero below ``beta``,
    identity above ``beta2``, linear ramp in between — interpolates
    between soft (β2→∞ rescaled) and hard (β2→β).  Requires β2 > β.
    Reference wish-list item (TODO.txt "More threshold types").
    ``beta``/``beta2`` are scalars or per-level/per-band sequences of
    the same structure."""
    n = coeffs.levels
    out = _map_details(
        coeffs,
        lambda x, i, j: _firm(x, _resolve_beta(beta, i, j, normalize),
                              _resolve_beta(beta2, i, j, normalize)),
    )
    if do_thresh_appcoeffs:
        out = type(coeffs)(
            _firm(coeffs.approx, _app_beta(beta, n, normalize),
                  _app_beta(beta2, n, normalize)),
            out.details)
    return out


def shrink(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = True) -> Coeffs:
    """L2 proximal: scale everything by 1/(1+beta), reference:
    src/common.cu:347-371."""
    def scale(x):
        return x * jnp.asarray(1.0 / (1.0 + beta), x.dtype)

    out = _map_details(coeffs, lambda x, i, j: scale(x))
    if do_thresh_appcoeffs:
        out = type(coeffs)(scale(coeffs.approx), out.details)
    return out
