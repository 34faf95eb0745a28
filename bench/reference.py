"""Plain float64 reference of the periodized wavelet transforms.

Independent of the system under test: it imports nothing of it and
derives its own filters.  It states the index semantics of the
periodized transforms directly (the conventions of PDWT, the CUDA
library the system reimplements, which are pywt's filter conventions):

* decimated analysis, centre ``c = hlen//2`` for odd ``hlen``, else
  ``hlen//2 - 1``:  ``out[n] = sum_j f[hlen-1-j] * x[(2n - c + j) mod N]``
* decimated synthesis, ``h2 = hlen//2``, ``s = 2*(h2//2) + (h2 % 2)``,
  ``u`` the zero-stuffed coefficients of length ``2M``:
  ``out[g] = sum_j r[hlen-1-j] * u[(g - s + j) mod 2M]`` for each of the
  lowpass and highpass channels, summed
* undecimated (a trous) analysis at level ``l`` with ``f = 2**(l-1)``:
  ``out[n] = sum_j f[hlen-1-j] * x[(n - c*f + f*j) mod N]``
* undecimated synthesis: ``out[n] = sum_j r[hlen-1-j]/2 *
  x[(n - (hlen//2)*f + f*j) mod N]`` per channel, summed

In 2D the first pass runs along the last axis, the second along the
first; ``H`` is the highpass along the first axis.  Coefficients are
``(approx, [(H, V, D) for level 1 .. L])``, level 1 the finest.

Every pass is a sum of strided views of a periodically padded copy,
computed by threads over blocks of the other axis: NumPy releases the
GIL in its array arithmetic, so the passes use up to 16 cores.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from math import comb

import numpy as np

_THREADS = max(1, min(16, os.cpu_count() or 1))
_BLOCK = 64  # lines of the other axis per task


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def daubechies(n: int) -> np.ndarray:
    """Scaling filter of the Daubechies wavelet with ``n`` vanishing
    moments (length ``2n``, extremal phase), by spectral factorisation:
    ``|m0|^2 = cos^2n(w/2) P(sin^2(w/2))`` with
    ``P(y) = sum_k C(n-1+k, k) y^k``; the roots of ``P`` inside the unit
    circle (in ``z``) give the minimum-phase factor."""
    p = [comb(n - 1 + k, k) for k in range(n)]          # P(y), ascending
    zeros = [-1.0] * n
    for y in np.roots(p[::-1]):
        # y = (2 - z - 1/z)/4  <=>  z^2 - (2 - 4y) z + 1 = 0
        r = np.roots([1.0, -(2.0 - 4.0 * y), 1.0])
        zeros.append(r[np.argmin(np.abs(r))])
    h = np.real(np.poly(zeros))
    return h * (np.sqrt(2.0) / h.sum())


def filters(name: str) -> dict:
    """``dec_lo, dec_hi, rec_lo, rec_hi`` of ``dbN`` (pywt conventions)."""
    if not name.startswith("db"):
        raise ValueError(f"the reference derives Daubechies filters only, "
                         f"not {name!r}")
    rec_lo = daubechies(int(name[2:]))
    k = np.arange(len(rec_lo))
    rec_hi = np.where(k % 2, -1.0, 1.0) * rec_lo[::-1]
    return dict(dec_lo=rec_lo[::-1].copy(), dec_hi=rec_hi[::-1].copy(),
                rec_lo=rec_lo, rec_hi=rec_hi)


def _fwd_centre(hlen: int) -> int:
    return hlen // 2 if hlen % 2 else hlen // 2 - 1


# ---------------------------------------------------------------------------
# one periodic pass along an axis
# ---------------------------------------------------------------------------

def _corr(x: np.ndarray, taps, axis: int, step: int, m: int) -> np.ndarray:
    """``out[.., i, ..] = sum_k w_k * x[.., (step*i + o_k) mod N, ..]``
    along ``axis`` (0 or 1 of a 2D array) for ``i in [0, m)``, with
    ``taps = [(w_k, o_k), ...]``."""
    n = x.shape[axis]
    lo = min(o for _, o in taps)
    hi = max(o for _, o in taps)
    span = step * (m - 1) + 1
    idx = np.arange(lo, hi + span) % n
    other = x.shape[1 - axis]
    shape = (m, other) if axis == 0 else (other, m)
    out = np.empty(shape, np.float64)

    def block(b0):
        sl = slice(b0, min(b0 + _BLOCK, other))
        if axis == 0:
            xp = x[:, sl][idx]
            view = lambda o: xp[o - lo:o - lo + span:step]
            dst = out[:, sl]
        else:
            xp = x[sl][:, idx]
            # one contiguous copy per phase, so every tap reads a
            # contiguous slice
            ph = [np.ascontiguousarray(xp[:, p::step]) for p in range(step)]
            view = lambda o: ph[(o - lo) % step][:, (o - lo) // step:
                                                 (o - lo) // step + m]
            dst = out[sl]
        acc = np.zeros(dst.shape)
        tmp = np.empty(dst.shape)
        for w, o in taps:
            np.multiply(view(o), w, out=tmp)
            acc += tmp
        dst[...] = acc

    with ThreadPoolExecutor(_THREADS) as pool:
        list(pool.map(block, range(0, other, _BLOCK)))
    return out


class NumPy64:
    """How the passes compute: float64 NumPy, strided views."""
    xp = np
    corr = staticmethod(_corr)


def _analysis(x, filt, axis, f=None, ops=NumPy64):
    """(lo, hi) of one analysis pass; ``f`` is the a trous dilation
    (undecimated) or None (decimated)."""
    hlen = len(filt["dec_lo"])
    c = _fwd_centre(hlen)
    n = x.shape[axis]
    if f is None:
        step, m, offs = 2, n // 2, [j - c for j in range(hlen)]
    else:
        step, m, offs = 1, n, [f * j - c * f for j in range(hlen)]
    return tuple(ops.corr(x, [(filt[k][hlen - 1 - j], o)
                              for j, o in enumerate(offs)], axis, step, m)
                 for k in ("dec_lo", "dec_hi"))


def _synthesis(lo, hi, filt, axis, f=None, ops=NumPy64):
    """One synthesis pass combining the two channels."""
    hlen = len(filt["rec_lo"])
    r = {"lo": filt["rec_lo"], "hi": filt["rec_hi"]}
    if f is not None:
        c = (hlen // 2) * f
        return sum(ops.corr(a, [(r[k][hlen - 1 - j] / 2.0, f * j - c)
                                for j in range(hlen)], axis, 1,
                            a.shape[axis])
                   for k, a in (("lo", lo), ("hi", hi)))
    h2 = hlen // 2
    s = 2 * (h2 // 2) + (h2 % 2)
    m = lo.shape[axis]
    shape = list(lo.shape)
    shape[axis] = 2 * m
    parts = []
    for p in (0, 1):
        # g = 2i + p draws u at (g - s + j), even only: t = i + (p-s+j)/2
        parts.append(sum(
            ops.corr(a, [(r[k][hlen - 1 - j], (p - s + j) // 2)
                         for j in range(hlen) if (p - s + j) % 2 == 0],
                     axis, 1, m)
            for k, a in (("lo", lo), ("hi", hi))))
    # interleave: out[2i + p] = parts[p][i] along the axis
    return ops.xp.stack(parts, axis=axis + 1).reshape(shape)


# ---------------------------------------------------------------------------
# 2D transforms
# ---------------------------------------------------------------------------

def forward2d(x, filt, levels, swt=False, ops=NumPy64):
    """Multi-level 2D transform: ``(approx, [(H, V, D), ...])``."""
    a = x
    details = []
    for lvl in range(1, levels + 1):
        f = (1 << (lvl - 1)) if swt else None
        lo_x, hi_x = _analysis(a, filt, 1, f, ops)
        a, h = _analysis(lo_x, filt, 0, f, ops)
        v, d = _analysis(hi_x, filt, 0, f, ops)
        details.append((h, v, d))
    return a, details


def inverse2d(approx, details, filt, swt=False, ops=NumPy64):
    a = approx
    for i in range(len(details) - 1, -1, -1):
        f = (1 << i) if swt else None
        h, v, d = details[i]
        t0 = _synthesis(a, h, filt, 0, f, ops)
        t1 = _synthesis(v, d, filt, 0, f, ops)
        a = _synthesis(t0, t1, filt, 1, f, ops)
    return a


def denoise2d(x, cfg, *, image=True, ops=NumPy64):
    """The configuration's denoise step: forward, soft threshold of the
    details at ``cfg["beta"]``, L1 norm of all thresholded coefficients
    (approximation included) and, with ``image``, the inverse.  Returns
    a dict of ``coeffs`` (``[approx, H1, V1, D1, H2, ...]``), ``norm1``
    and ``image``; float64 NumPy unless ``ops`` says otherwise."""
    xp = ops.xp
    filt = filters(cfg["wavelet"])
    swt = cfg["transform"] == "swt2d"
    if ops is NumPy64:
        x = np.asarray(x, np.float64)
    a, det = forward2d(x, filt, cfg["levels"], swt, ops)
    soft = lambda t: xp.sign(t) * xp.maximum(xp.abs(t) - cfg["beta"], 0.0)
    det = [tuple(soft(b) for b in lvl) for lvl in det]
    leaves = [a] + [b for lvl in det for b in lvl]
    out = {"coeffs": leaves,
           "norm1": sum(xp.abs(t).sum() for t in leaves)}
    if image:
        out["image"] = inverse2d(a, det, filt, swt, ops)
    return out


def work2d(cfg) -> dict:
    """Irreducible work of one denoise step, from the shapes alone.

    Bytes: the input read once and the returned image written once
    (intermediate coefficients are not counted: a fused implementation
    need not store them).  FLOPs: the direct-convolution count, 2 per
    multiply-add, ``hlen`` multiply-adds per output sample of each pass:
    per input sample of a level, 2*hlen for a decimated level and
    6*hlen for an undecimated one; synthesis the same again."""
    ny, nx = cfg["shape"]
    hlen = 2 * int(cfg["wavelet"][2:])
    item = np.dtype(cfg["dtype"]).itemsize
    per_level = 6 * hlen if cfg["transform"] == "swt2d" else 2 * hlen
    shrink = 1 if cfg["transform"] == "swt2d" else 4
    samples = sum(ny * nx / shrink ** i for i in range(cfg["levels"]))
    return {"bytes": 2 * ny * nx * item,
            "flops": 2 * 2 * per_level * samples}
