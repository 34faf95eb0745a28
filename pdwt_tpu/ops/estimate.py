"""Data-driven threshold selection on coefficient pytrees.

The reference leaves choosing ``beta`` entirely to the user (its demo
hard-codes 10.0, reference: src/demo.cpp:38); these are the standard
wavelet-shrinkage estimators, computed on-device in the same jitted
program as the transform so a full auto-tuned denoise step stays one
XLA program with no host syncs:

* :func:`noise_sigma` — Donoho-Johnstone robust noise estimate,
  MAD of the finest all-highpass band / Φ⁻¹(3/4).
* :func:`universal_threshold` — VisuShrink σ·sqrt(2 ln N).
* :func:`bayes_thresholds` — BayesShrink per-band σ²/σ_x, returned as a
  nested per-level/per-band tuple that every threshold op accepts
  directly as its ``beta`` argument.

All work on 1D/2D/3D coefficient pytrees (DWT or SWT) and return traced
scalars — safe inside jit/grad.
"""
from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp

from .threshold import Coeffs

# 1/Phi^{-1}(3/4): MAD -> sigma for a Gaussian
_MAD_TO_SIGMA = 1.0 / 0.6744897501960817


def _finest_diag(coeffs: Coeffs):
    """Finest all-highpass band: D in 2D, ddd in 3D (the last band of
    level 0), the level-0 detail in 1D — the band with the least signal
    leakage, hence the standard one for noise estimation."""
    det = coeffs.details[0]
    return det[-1] if isinstance(det, tuple) else det


def noise_sigma(coeffs: Coeffs) -> jnp.ndarray:
    """Robust noise standard deviation: median(|d|)·1.4826 over the
    finest diagonal detail band (Donoho & Johnstone 1994)."""
    d = _finest_diag(coeffs).astype(jnp.float32)
    return jnp.median(jnp.abs(d)) * jnp.float32(_MAD_TO_SIGMA)


def _per_band(coeffs: Coeffs, band_t):
    """Apply ``band_t`` to every detail band, preserving the pytree's
    per-level structure (tuple-of-bands or bare array)."""
    return tuple(
        tuple(band_t(b) for b in det) if isinstance(det, tuple)
        else band_t(det)
        for det in coeffs.details)


def _detail_count(coeffs: Coeffs) -> int:
    n = 0
    for det in coeffs.details:
        bands = det if isinstance(det, tuple) else (det,)
        for b in bands:
            n += int(b.size)
    return n


def universal_threshold(coeffs: Coeffs,
                        sigma: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """VisuShrink universal threshold σ·sqrt(2·ln N) with N the total
    detail-coefficient count; σ defaults to :func:`noise_sigma`."""
    if sigma is None:
        sigma = noise_sigma(coeffs)
    return sigma * jnp.float32(math.sqrt(2.0 * math.log(_detail_count(coeffs))))


def sure_thresholds(coeffs: Coeffs,
                    sigma: Optional[jnp.ndarray] = None,
                    hybrid: bool = True):
    """SureShrink (Donoho & Johnstone 1995) per-band soft thresholds:
    minimize Stein's unbiased risk estimate
    ``SURE(t) = n·σ² − 2σ²·#{|d| ≤ t} + Σ min(d², t²)`` over the n+1
    candidate thresholds {0} ∪ {|d_i|} — an exact argmin via one sort +
    cumsum per band (static shapes, jit/grad-safe).  With
    ``hybrid=True`` a band whose energy is too sparse for SURE to be
    reliable falls back to the universal threshold
    σ·sqrt(2 ln n) (the classic hybrid scheme).  Returns the same
    nested structure as :func:`bayes_thresholds`."""
    if sigma is None:
        sigma = noise_sigma(coeffs)
    sigma = sigma.astype(jnp.float32)
    s2 = sigma * sigma

    def band_t(d):
        d = d.astype(jnp.float32).ravel()
        n = d.size
        a = jnp.sort(d * d)  # ascending d²
        # candidate t = |d|_(k) (k-th smallest magnitude): exactly k
        # coords satisfy |d| ≤ t, and Σ min(d², t²) = csum[k-1] + (n−k)·a[k-1]
        ks = jnp.arange(1, n + 1, dtype=jnp.float32)
        csum = jnp.cumsum(a)
        risk = (n * s2 - 2.0 * s2 * ks
                + csum + (n - ks) * a)
        k = jnp.argmin(risk)
        t_sure = jnp.sqrt(a[k])
        # the t = 0 candidate (threshold nothing) has SURE = n·σ²
        t_best = jnp.where(risk[k] < n * s2, t_sure, 0.0)
        if not hybrid:
            return t_best
        t_univ = sigma * jnp.float32(math.sqrt(2.0 * math.log(max(n, 2))))
        # sparsity test (D&J 1995): if Σ(d²/σ²−1)/n ≤ n^{-1/2}·ln(n)^{3/2},
        # SURE is unreliable — use the universal threshold
        sparse = ((csum[-1] / s2 - n) / n
                  <= jnp.float32(n ** -0.5 * math.log(max(n, 2)) ** 1.5))
        return jnp.where(sparse, t_univ, t_best)

    return _per_band(coeffs, band_t)


def bayes_thresholds(coeffs: Coeffs,
                     sigma: Optional[jnp.ndarray] = None):
    """BayesShrink (Chang, Yu & Vetterli 2000) per-band soft thresholds
    t = σ²/σ_x with σ_x² = max(E[d²] − σ², 0); a band with no estimated
    signal gets max|d| (fully suppressed).  Returns a per-level tuple of
    per-band tuples (a per-level scalar for 1D pytrees) — pass straight
    as the ``beta`` of :func:`pdwt_tpu.ops.soft_threshold` et al."""
    if sigma is None:
        sigma = noise_sigma(coeffs)
    sigma = sigma.astype(jnp.float32)
    s2 = sigma * sigma

    def band_t(d):
        d = d.astype(jnp.float32)
        sx = jnp.sqrt(jnp.maximum(jnp.mean(d * d) - s2, 0.0))
        return jnp.where(sx > 0, s2 / jnp.where(sx > 0, sx, 1.0),
                         jnp.max(jnp.abs(d)))

    return _per_band(coeffs, band_t)
