"""Continuous wavelet transform (CWT) — scaleogram analysis.

Beyond the reference (PDWT is a DWT/SWT library); included because the
same tomography/signal users reach for scaleograms next, and the
transform maps perfectly onto XLA: ONE forward FFT of the signal, a
broadcast multiply against the whole scale bank, ONE batched inverse
FFT over a (scales, n) block — all XLA-fused, no Python loop over
scales.

Conventions are Torrence & Compo 1998 ("A Practical Guide to Wavelet
Analysis") exactly, so the reconstruction constants are citable:

* ``morlet`` (ω0 = 6): analytic, ψ̂0(sω) = π^{-1/4} H(ω) e^{-(sω-ω0)²/2},
  complex output; Fourier wavelength λ = 4πs / (ω0 + sqrt(2 + ω0²)).
* ``ricker`` (DOG m=2, a.k.a. mexican hat):
  ψ̂0(sω) = -Γ(2.5)^{-1/2} (sω)² e^{-(sω)²/2}, real output;
  λ = 2πs / sqrt(2.5).
* ``paul`` (order m = 4): analytic,
  ψ̂0(sω) = 2^m / sqrt(m (2m-1)!) · (sω)^m e^{-sω} H(ω), complex
  output; λ = 4πs / (2m + 1).  Better time localization (shorter
  e-folding s/√2) at the cost of scale resolution — the standard
  choice for sharp transients.

2D: :func:`cwt2d` is the oriented 2D Morlet scaleogram (one 2D FFT,
one broadcast multiply against the whole (scale, angle) bank, one
batched inverse FFT — the same shape as the 1D path), and
:func:`cone_of_influence` marks the edge-affected region of a 1D
scaleogram (T&C §3g).

Energy normalization ψ̂(sω_k) = sqrt(2πs/dt)·ψ̂0(sω) (T&C eq. 6) makes
|W|² directly comparable across scales.  :func:`icwt` implements the
delta-function reconstruction (T&C eq. 11) for log-spaced scales —
accurate to a few percent when the scales span the signal's band.

Everything is jit/vmap/grad-safe with static shapes; leading axes of
``x`` are batch.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

_OMEGA0 = 6.0
_PAUL_M = 4
# T&C table 2: reconstruction factor Cδ and ψ0(0) per mother wavelet
_CDELTA = {"morlet": 0.776, "ricker": 3.541, "paul": 1.132}
_PSI00 = {"morlet": math.pi ** -0.25, "ricker": 0.867, "paul": 1.079}
#: e-folding TIME of |ψ(t)|² as a multiple of the scale (T&C table 1):
#: τ_s = c·s; the cone of influence at distance d from an edge is the
#: scale s = d/c past which the wavelet support crosses the boundary.
_EFOLD = {"morlet": math.sqrt(2.0), "ricker": math.sqrt(2.0),
          "paul": 1.0 / math.sqrt(2.0)}


def _ang_freq(n: int, dt: float) -> np.ndarray:
    """ω_k = 2πk/(n dt) with the sign convention of T&C eq. 5."""
    k = np.fft.fftfreq(n, d=dt)  # cycles per unit time
    return 2.0 * math.pi * k


def _psi_hat(wavelet: str, s: np.ndarray, omega: np.ndarray,
             dt: float) -> np.ndarray:
    """ψ̂(s_j ω_k), shape (S, n); numpy — scales are static."""
    so = s[:, None] * omega[None, :]
    if wavelet == "morlet":
        base = (math.pi ** -0.25) * np.exp(
            -0.5 * np.minimum((so - _OMEGA0) ** 2, 700.0))
        base = base * (omega[None, :] > 0)
    elif wavelet == "ricker":
        base = (-(so ** 2) * np.exp(-0.5 * np.minimum(so ** 2, 700.0))
                / math.sqrt(math.gamma(2.5)))
    elif wavelet == "paul":
        m = _PAUL_M
        cm = 2.0 ** m / math.sqrt(m * math.factorial(2 * m - 1))
        pos = so > 0
        base = cm * np.where(pos, so, 0.0) ** m * np.exp(
            -np.minimum(np.where(pos, so, 0.0), 700.0)) * pos
    else:
        raise ValueError(f"unknown wavelet {wavelet!r}; "
                         f"pick from {sorted(_CDELTA)}")
    norm = np.sqrt(2.0 * math.pi * s[:, None] / dt)
    return (norm * base).astype(np.float32)


def fourier_wavelength(wavelet: str, scales) -> np.ndarray:
    """Equivalent Fourier wavelength per scale (T&C table 1)."""
    s = np.asarray(scales, np.float64)
    if wavelet == "morlet":
        return 4.0 * math.pi * s / (_OMEGA0 + math.sqrt(2 + _OMEGA0 ** 2))
    if wavelet == "ricker":
        return 2.0 * math.pi * s / math.sqrt(2.5)
    if wavelet == "paul":
        return 4.0 * math.pi * s / (2 * _PAUL_M + 1)
    raise ValueError(f"unknown wavelet {wavelet!r}")


def log_scales(n: int, dt: float = 1.0, *, dj: float = 0.125,
               s0: Optional[float] = None,
               j1: Optional[int] = None) -> np.ndarray:
    """T&C eq. 9-10 log-spaced scale grid: s_j = s0·2^{j·dj}, default
    s0 = 2dt up to the n·dt window."""
    s0 = 2.0 * dt if s0 is None else s0
    if j1 is None:
        j1 = int(math.log2(n * dt / s0) / dj)
    return s0 * 2.0 ** (dj * np.arange(j1 + 1))


def cwt(x: jnp.ndarray, scales, wavelet: str = "morlet", *,
        dt: float = 1.0) -> jnp.ndarray:
    """CWT over the trailing axis: returns ``batch + (S, n)`` —
    complex64 for the analytic mothers (``morlet``, ``paul``), real for
    ``ricker``.  Periodic boundary (FFT), matching the DWT engines'
    boundary convention."""
    n = x.shape[-1]
    s = np.asarray(scales, np.float64)
    if s.ndim != 1 or s.size == 0 or (s <= 0).any():
        raise ValueError("scales must be a non-empty 1D positive array")
    psi = jnp.asarray(_psi_hat(wavelet, s, _ang_freq(n, dt), dt))
    X = jnp.fft.fft(x.astype(jnp.float32), axis=-1)
    # T&C eq. 4: W(s) = ifft(X · ψ̂(sω)); ψ̂ real, so no conjugate
    Wf = X[..., None, :] * psi
    W = jnp.fft.ifft(Wf, axis=-1)
    if wavelet == "ricker":
        return jnp.real(W)
    return W


def icwt(W: jnp.ndarray, scales, wavelet: str = "morlet", *,
         dt: float = 1.0, dj: float = 0.125) -> jnp.ndarray:
    """Approximate inverse (T&C eq. 11) for LOG-SPACED scales with
    spacing ``dj`` (e.g. from :func:`log_scales`):
    x_n = dj·sqrt(dt) / (Cδ ψ0(0)) · Σ_j Re(W_j)/sqrt(s_j)."""
    s = jnp.asarray(np.asarray(scales, np.float64), jnp.float32)
    fac = dj * math.sqrt(dt) / (_CDELTA[wavelet] * _PSI00[wavelet])
    return fac * jnp.sum(jnp.real(W) / jnp.sqrt(s)[..., :, None],
                         axis=-2)


def cone_of_influence(n: int, dt: float = 1.0,
                      wavelet: str = "morlet") -> np.ndarray:
    """Cone of influence in SCALE units, length ``n``: at sample t the
    coefficients with scale s > coi[t] are contaminated by the periodic
    boundary (the wavelet's e-folding support τ_s = c·s crosses the
    nearer edge; T&C §3g, table 1).  Mask a scaleogram with
    ``np.asarray(scales)[:, None] <= coi[None, :]``."""
    if wavelet not in _EFOLD:
        raise ValueError(f"unknown wavelet {wavelet!r}; "
                         f"pick from {sorted(_EFOLD)}")
    t = np.arange(n, dtype=np.float64)
    dist = np.minimum(t, n - 1 - t) + 0.5
    return dist * dt / _EFOLD[wavelet]


# ---------------------------------------------------------------------------
# 2D scaleogram (oriented Morlet)
# ---------------------------------------------------------------------------

def _psi_hat_2d(s: np.ndarray, thetas: np.ndarray, nr: int, nc: int,
                dt: float, sigma: float) -> np.ndarray:
    """2D Morlet bank ψ̂(s R_θ k), shape (S, Θ, nr, nc); numpy (static).

    ψ̂0(k) = exp(-σ²|k - k0|²/2) with k0 = (ω0/σ?, 0) — the standard
    directional Morlet: a Gaussian in the frequency plane centred at
    wavenumber ω0 along orientation θ, L2-normalized per scale so
    |W|² is comparable across the bank (the 2D analogue of T&C eq. 6)."""
    ky = 2 * math.pi * np.fft.fftfreq(nr, d=dt)
    kx = 2 * math.pi * np.fft.fftfreq(nc, d=dt)
    KY, KX = np.meshgrid(ky, kx, indexing="ij")  # (nr, nc)
    out = np.empty((len(s), len(thetas), nr, nc), np.float32)
    for j, sj in enumerate(s):
        for i, th in enumerate(thetas):
            # rotate the wave-vector grid into the wavelet frame
            kxr = math.cos(th) * KX + math.sin(th) * KY
            kyr = -math.sin(th) * KX + math.cos(th) * KY
            r2 = (sj * kxr - _OMEGA0) ** 2 + (sj * kyr) ** 2
            base = np.exp(-0.5 * np.minimum(sigma ** 2 * r2, 700.0))
            # L2 normalization: in 2D, s·ψ̂0(sk) keeps ||ψ_s||₂ flat
            # across scales (∫|s ψ̂0(sk)|² d²k is s-independent); the
            # 2π/dt carries the discrete-FFT measure like the 1D
            # sqrt(2πs/dt) convention (T&C eq. 6 squared per axis).
            out[j, i] = (2 * math.pi * sj / dt) * base
    return out


def cwt2d(x: jnp.ndarray, scales, thetas=None, *, dt: float = 1.0,
          sigma: float = 1.0) -> jnp.ndarray:
    """Oriented 2D Morlet scaleogram over the trailing two axes:
    returns ``batch + (S, Θ, nr, nc)`` complex64.

    One 2D FFT of the image, one broadcast multiply against the whole
    (scale, angle) bank, one batched inverse FFT — no Python loop over
    the bank reaches the device.  ``thetas`` defaults to 4 orientations
    (0, π/4, π/2, 3π/4); ``sigma`` widens the angular/scale selectivity
    (the Gaussian envelope of the directional Morlet)."""
    nr, nc = x.shape[-2:]
    s = np.asarray(scales, np.float64)
    if s.ndim != 1 or s.size == 0 or (s <= 0).any():
        raise ValueError("scales must be a non-empty 1D positive array")
    th = (np.linspace(0.0, math.pi, 4, endpoint=False) if thetas is None
          else np.asarray(thetas, np.float64))
    psi = jnp.asarray(_psi_hat_2d(s, th, nr, nc, dt, sigma))
    X = jnp.fft.fft2(x.astype(jnp.float32), axes=(-2, -1))
    Wf = X[..., None, None, :, :] * psi
    return jnp.fft.ifft2(Wf, axes=(-2, -1))
