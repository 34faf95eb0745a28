"""Wavelet filter bank.

A re-design of the reference filter machinery:

* the reference stores 288 hard-coded C arrays and a 72-entry registry
  (reference: src/filters.h:635-645, src/filters.cpp:5919-6002) and pushes
  the selected filters into CUDA ``__constant__`` memory
  (reference: src/separable.cu:48-51).  Here the public coefficient tables
  live in ``_data.npz`` and filters are plain numpy arrays that jitted
  functions close over — XLA embeds them as compile-time constants, the
  equivalent of constant memory.

* name lookup is case-insensitive (reference: src/separable.cu:32-41 uses
  strcasecmp) and the haar aliases db1 / bior1.1 / rbio1.1 / rbior1.1 are
  honored for every transform (the reference only honors them on the
  non-SWT fast path, src/separable.cu:24-28, and errors out for db1+SWT;
  we resolve the alias everywhere).

* custom filters: the reference caps user filters at 40 taps because of the
  constant-memory buffer (reference: src/common.h:15, src/wt.cu:562-565) and
  its own TODO list asks to lift that bound (reference: TODO.txt "Should
  allow > 40 coeffs").  Nothing in this design requires it — filters are
  jit-time constants — so arbitrary lengths are accepted; MAX_FILTER_WIDTH
  is kept only as documentation of the reference's limit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

# The REFERENCE's custom-filter bound (src/common.h:15, a CUDA
# __constant__ buffer size).  Informational only: this framework accepts
# longer filters (the reference's own TODO.txt asks for exactly that).
MAX_FILTER_WIDTH = 40

_DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_data.npz")

# Aliases resolving to haar (reference: src/separable.cu:24-28).
_HAAR_ALIASES = ("db1", "bior1.1", "rbio1.1", "rbior1.1")


@dataclasses.dataclass(frozen=True)
class Wavelet:
    """A 1D biorthogonal filter bank.

    Attributes
    ----------
    name:    canonical lower-case wavelet name.
    dec_lo:  forward (analysis) lowpass filter, float64, shape (hlen,).
    dec_hi:  forward (analysis) highpass filter.
    rec_lo:  inverse (synthesis) lowpass filter.
    rec_hi:  inverse (synthesis) highpass filter.

    Conventions match the reference registry fields f_l/f_h/i_l/i_h
    (reference: src/filters.h:640-644), which are pywt's
    dec_lo/dec_hi/rec_lo/rec_hi.
    """

    name: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray

    def __post_init__(self):
        for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
            arr = np.ascontiguousarray(np.asarray(getattr(self, f), dtype=np.float64))
            if arr.ndim != 1:
                raise ValueError(f"{f} must be 1D, got shape {arr.shape}")
            object.__setattr__(self, f, arr)
        hl = len(self.dec_lo)
        if not (len(self.dec_hi) == len(self.rec_lo) == len(self.rec_hi) == hl):
            raise ValueError("all four filters must have the same length")
        if hl < 2:
            raise ValueError("filter length must be >= 2")

    @property
    def hlen(self) -> int:
        return len(self.dec_lo)

    @property
    def is_haar_like(self) -> bool:
        """hlen==2 filters take the dedicated haar fast path when not SWT
        (reference: src/wt.cu:248,255 dispatch on hlen==2 && !do_swt)."""
        return self.hlen == 2

    def __hash__(self):
        return hash(
            (self.name, self.dec_lo.tobytes(), self.dec_hi.tobytes(),
             self.rec_lo.tobytes(), self.rec_hi.tobytes())
        )

    def __eq__(self, other):
        if not isinstance(other, Wavelet):
            return NotImplemented
        return (
            self.name == other.name
            and np.array_equal(self.dec_lo, other.dec_lo)
            and np.array_equal(self.dec_hi, other.dec_hi)
            and np.array_equal(self.rec_lo, other.rec_lo)
            and np.array_equal(self.rec_hi, other.rec_hi)
        )


_BUILTIN: Dict[str, Wavelet] = {}
_USER: Dict[str, Wavelet] = {}


def _load_builtin() -> None:
    if _BUILTIN:
        return
    # fill in one update, so a concurrent caller never sees a partial bank
    with np.load(_DATA_PATH) as data:
        bank = {name: Wavelet(name, *data[name][:4]) for name in data.files}
    _BUILTIN.update(bank)


def list_wavelets() -> Tuple[str, ...]:
    """All known wavelet names (72 built-ins + aliases + user-registered)."""
    _load_builtin()
    return tuple(sorted(set(_BUILTIN) | set(_HAAR_ALIASES) | set(_USER)))


def get_wavelet(name: str) -> Wavelet:
    """Case-insensitive lookup (reference: src/separable.cu:32-41).
    A ``modwt-`` prefix resolves the base name and applies
    :func:`modwt_wavelet` — so every name-taking API (the ``Wavelets``
    facade included) accepts e.g. ``"modwt-db4"`` directly."""
    _load_builtin()
    key = name.lower()
    if key in _USER:
        return _USER[key]
    if key.startswith("modwt-"):
        return modwt_wavelet(get_wavelet(key[len("modwt-"):]))
    if key in _HAAR_ALIASES:
        key = "haar"
    try:
        return _BUILTIN[key]
    except KeyError:
        raise ValueError(
            f"unknown wavelet {name!r}; available: {', '.join(list_wavelets())}"
        ) from None


def make_custom_wavelet(
    name: str,
    dec_lo,
    dec_hi,
    rec_lo,
    rec_hi,
) -> Wavelet:
    """Build a custom filter bank (reference: Wavelets::set_filters_forward /
    set_filters_inverse, src/wt.cu:560-602).  Unlike the reference, which
    rejects filters longer than its 40-tap constant-memory buffer (and whose
    TODO.txt asks to lift that), any length is accepted here: filters are
    jit-time constants."""
    return Wavelet(name.lower(), dec_lo, dec_hi, rec_lo, rec_hi)


def register_wavelet(w: Wavelet) -> None:
    """Register a custom wavelet under its (lower-cased) name for lookup."""
    _load_builtin()
    _USER[w.name.lower()] = w


def modwt_wavelet(wav) -> Wavelet:
    """The MODWT-normalized bank of ``wav``: analysis filters scaled by
    1/sqrt(2), synthesis by sqrt(2) (perfect reconstruction is a pure
    rescale, so every SWT path — all backends, sharding,
    3D — accepts the result unchanged).

    With this bank, :func:`~pdwt_tpu.core.separable.swt1d` & friends
    compute the maximal-overlap DWT of Percival & Walden (the
    convention time-series users expect, pywt's ``swt(..., norm=True)``)
    — for an orthonormal ``wav`` the coefficient energy at every level
    partitions the signal energy instead of doubling per level.  The
    reference has no such mode (its SWT is the unnormalized à-trous,
    src/separable.cu:409-493).  ``wav`` is a :class:`Wavelet` or name."""
    if isinstance(wav, str):
        wav = get_wavelet(wav)
    s = np.sqrt(0.5)
    return Wavelet("modwt-" + wav.name, wav.dec_lo * s, wav.dec_hi * s,
                   wav.rec_lo / s, wav.rec_hi / s)


def quad_filters(
    lo: np.ndarray, hi: np.ndarray, transpose_detail_convention: bool = False
) -> np.ndarray:
    """Outer-product 2D filter quad (LL, LH, HL, HH), shape (4, hlen, hlen).

    Reference: src/nonseparable.cu:16-24 (w_outer) and 70-74.  Note the
    reference pairs the H subband with outer(lo, hi) — lowpass along rows,
    highpass along columns — which is the *transpose* of what its own
    separable engine computes for H (highpass along rows: pass2 applies the
    highpass vertically, src/separable.cu:166).  Both are self-consistent
    (PR holds either way), but we default to the separable convention so the
    two engines produce identical subbands; pass
    ``transpose_detail_convention=True`` to reproduce the reference
    non-separable layout (src/nonseparable.cu:71-74).
    """
    ll = np.outer(lo, lo)
    lh = np.outer(hi, lo)  # H: highpass rows (y), lowpass cols (x)
    hl = np.outer(lo, hi)  # V: lowpass rows, highpass cols
    hh = np.outer(hi, hi)
    if transpose_detail_convention:
        lh, hl = hl, lh
    return np.stack([ll, lh, hl, hh])


def factor_quads(quads, rtol: float = 1e-9):
    """Factor a (LL, LH, HL, HH) quad set into per-axis 1D filters.

    Returns ``(lo_rows, hi_rows, lo_cols, hi_cols)`` such that
    LL = outer(lo_r, lo_c), LH = outer(hi_r, lo_c),
    HL = outer(lo_r, hi_c), HH = outer(hi_r, hi_c) — i.e. the quads are
    jointly separable — or None.  Used to route non-separable requests
    with (the overwhelmingly common) outer-product filters through the
    fast separable engine; genuinely 2D user quads
    (reference: src/nonseparable.cu:86-106) stay on the true-2D path.
    """
    q = np.asarray(quads, dtype=np.float64)
    if q.ndim != 3 or q.shape[0] != 4:
        return None
    scale = float(np.abs(q).max())
    if scale == 0.0:
        return None

    def rank1(m):
        u, s, vt = np.linalg.svd(m)
        if s[0] < rtol * scale or (len(s) > 1 and s[1] > rtol * scale):
            return None
        r = np.sqrt(s[0])
        return u[:, 0] * r, vt[0] * r

    f_ll, f_hh = rank1(q[0]), rank1(q[3])
    if f_ll is None or f_hh is None:
        return None
    lo_r, lo_c = f_ll
    hi_r, hi_c = f_hh
    # Remaining freedom: hi_r *= a, hi_c /= a.  LH fixes a; HL must then
    # match with the reciprocal ratio.
    base = np.outer(hi_r, lo_c)
    denom = float(np.vdot(base, base))
    if denom < (rtol * scale) ** 2:
        return None
    a = float(np.vdot(base, q[1])) / denom
    if abs(a) < rtol:
        return None
    # rtol=0: the atol = rtol*scale bound must be the only tolerance, or
    # numpy's default rtol=1e-5 silently loosens the advertised strictness.
    if not np.allclose(q[1], a * base, rtol=0.0, atol=rtol * scale):
        return None
    if not np.allclose(q[2], np.outer(lo_r, hi_c) / a, rtol=0.0,
                       atol=rtol * scale):
        return None
    return lo_r, a * hi_r, lo_c, hi_c / a
