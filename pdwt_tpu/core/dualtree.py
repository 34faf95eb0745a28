"""Dual-tree complex wavelet transform (Kingsbury DT-CWT), 1D and 2D.

Two parallel orthonormal DWT trees whose wavelets form an approximate
Hilbert pair, so the COMPLEX coefficient magnitudes are nearly
shift-invariant (the DWT's aliasing cancels between trees) and the 2D
transform resolves SIX orientations (±15°, ±45°, ±75°) instead of the
real DWT's three — at 2x (1D) / 4x (2D) redundancy, far below the
undecimated SWT's levels-fold cost.  Beyond the reference: PDWT has
DWT/SWT only (src/wt.cu).

Filter design — derived, not tabulated.  Selesnick's common-factor
construction (IEEE SPL 2001/2002, the q-shift relationship): tree B's
lowpass is tree A's times the maximally flat Thiran allpass
``z^-L d(1/z) / d(z)`` approximating a half-sample delay, i.e.

    H0(z) = F(z) d(z),     G0(z) = F(z) z^-L d(1/z)

with the COMMON factor F designed so each bank is an orthonormal CQF:
R(z) = F(z)F(1/z) = (1+z)^K (1+1/z)^K T(z) solves the halfband system
[R*S](even) = delta (S = d·d~ known), and F is the spectral factor of
R (inside-unit-circle roots + the K zeros at z=-1).  Measured on the
resulting banks (tests/test_dualtree.py): perfect reconstruction at
machine precision and ~0.5% negative-frequency energy of
psi_A + i psi_B at the default (L=3, K=4, 14 taps).

Level 1 uses tree A's bank in both trees with tree B's input rolled by
one sample (the standard one-sample-offset first stage: deeper levels
then see quarter-offset sampling grids); levels >= 2 use the (A, B)
half-delay pair.  Periodic boundaries throughout (core/conv.py index
semantics; the roll is exact under them).

The per-tree level transforms ride the framework's own engines: the
uniform-tree combos dispatch through core.separable; the mixed
row/col-tree combos of the 2D transform run
the per-axis conv passes.
"""
from __future__ import annotations

import functools
from math import comb
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..filters import Wavelet
from . import conv
from . import separable as sep
from .separable import Coeffs1D, Coeffs2D
from .shapes import level_sizes

_SQ2 = np.sqrt(2.0)


# ---------------------------------------------------------------------------
# filter design
# ---------------------------------------------------------------------------

def _thiran_half(L: int, tau: float = 0.54) -> np.ndarray:
    """Denominator d of the maximally flat allpass z^-L d(1/z)/d(z)
    whose phase delay is L + tau (flat at DC).  The default biases the
    nominal half-sample delay slightly high: maximal flatness AT DC
    underweights the top of the lowpass band where the Thiran delay
    sags, and tau = 0.54 measured the lowest shift-variance across
    levels (1D impulse sweep: [0, 4.3, 13, 13]% vs [0, 5.9, 18, 18]%
    at tau = 0.5 — and vs [26, 91, 123, 89]% for a plain DWT)."""
    D = L + tau
    a = np.zeros(L + 1)
    for k in range(L + 1):
        p = 1.0
        for n in range(L + 1):
            p *= (D - L + n) / (D - L + k + n)
        a[k] = (-1) ** k * comb(L, k) * p
    return a


@functools.lru_cache(maxsize=None)
def design_dtcwt_banks(L: int = 2, K: int = 4):
    """(h0, g0): the common-factor Hilbert-pair lowpass banks as float64
    arrays (orthonormal CQFs of length K + L + ceil stuff; the default
    gives 14 taps).  Cached; pure numpy."""
    d = _thiran_half(L)
    S = np.convolve(d, d[::-1])
    q = np.array([comb(K, i) for i in range(K + 1)], float)
    QK = np.convolve(q, q[::-1])
    for Nf in range(K + 2, 64):
        M = Nf - 1 - K
        ncon = (Nf - 1 + L) // 2 + 1
        if M + 1 == ncon:
            break
    else:  # pragma: no cover - only tiny L/K are used
        raise ValueError(f"no consistent degree for L={L}, K={K}")
    A = np.zeros((ncon, M + 1))
    b = np.zeros(ncon)
    b[0] = 1.0
    base = np.convolve(QK, S)
    for j in range(M + 1):
        T = np.zeros(2 * M + 1)
        T[M + j] += 1.0
        T[M - j] += 1.0
        if j == 0:
            T[M] = 1.0
        P = np.convolve(base, T)
        c = len(P) // 2
        for m in range(ncon):
            A[m, j] = P[c + 2 * m]
    t = np.linalg.solve(A, b)
    T = np.zeros(2 * M + 1)
    T[M] = t[0]
    for j in range(1, M + 1):
        T[M + j] = t[j]
        T[M - j] = t[j]
    w = np.linspace(0, np.pi, 4096)
    Tw = np.real(np.polyval(T, np.exp(1j * w)) * np.exp(-1j * w * M))
    if Tw.min() < -1e-9:  # pragma: no cover - defaults validated in tests
        raise ValueError(f"T(w) not nonnegative for L={L}, K={K}: "
                         f"{Tw.min():.2e} — pick other orders")
    rts = np.roots(T)
    f1 = np.real(np.poly(rts[np.abs(rts) < 1.0]))
    F = np.convolve(f1, q)
    h0 = np.convolve(F, d)
    h0 /= np.linalg.norm(h0)
    g0 = np.convolve(F, d[::-1])
    g0 /= np.linalg.norm(g0)
    return h0, g0


def _orth_wavelet(name: str, h0: np.ndarray) -> Wavelet:
    n = len(h0)
    h1 = np.array([(-1) ** k * h0[n - 1 - k] for k in range(n)])
    return Wavelet(name, h0, h1, h0[::-1], h1[::-1])


@functools.lru_cache(maxsize=None)
def dtcwt_wavelets(L: int = 2, K: int = 4) -> Tuple[Wavelet, Wavelet]:
    """The (tree A, tree B) orthonormal banks as :class:`Wavelet`
    objects usable with every transform in the framework."""
    if L % 2:
        raise ValueError("L must be even: the transform compensates the "
                         "allpass's integer delay L by rolling tree B "
                         "L/2 samples per level")
    h0, g0 = design_dtcwt_banks(L, K)
    return (_orth_wavelet(f"dtcwt-a-{L}-{K}", h0),
            _orth_wavelet(f"dtcwt-b-{L}-{K}", g0))


# ---------------------------------------------------------------------------
# 1D transform
# ---------------------------------------------------------------------------

class DTCoeffs1D(NamedTuple):
    """``details[j]`` is the COMPLEX detail of level j+1 (finest
    first): (d_A + i d_B)/sqrt(2).  ``approx`` stacks the two trees'
    final lowpass on a leading axis (needed for exact inversion)."""
    approx: jnp.ndarray                       # (2,) + batch + (n_J,)
    details: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def dtcwt1d(x: jnp.ndarray, levels: int, *,
            order: Tuple[int, int] = (2, 4),
            backend: Optional[str] = None) -> DTCoeffs1D:
    """Dual-tree complex 1D DWT over the trailing axis (leading axes
    are batch).  Sizes must be even at every level (divisible by
    2^levels is the safe rule — the two trees' grids must stay
    aligned)."""
    wa, wb = dtcwt_wavelets(*order)
    roll = -_treeB_roll(order[0])
    n = x.shape[-1]
    if n % (1 << levels):
        raise ValueError(f"size {n} not divisible by 2^{levels} "
                         "(the dual trees' grids would desynchronize)")
    ca = sep.dwt1d(x, wa, levels, backend=backend)
    c1 = sep.dwt1d(jnp.roll(x, 1, axis=-1), wa, 1, backend=backend)
    b_details = [c1.details[0]]
    b_approx = c1.approx
    for _ in range(1, levels):
        c = sep.dwt1d(b_approx, wb, 1, backend=backend)
        # undo the allpass's integer delay (L input samples = L/2 out)
        b_approx = jnp.roll(c.approx, roll, axis=-1)
        b_details.append(jnp.roll(c.details[0], roll, axis=-1))
    details = tuple((_real(da) + 1j * _real(db)) / _SQ2
                    for da, db in zip(ca.details, b_details))
    return DTCoeffs1D(jnp.stack([ca.approx, b_approx], axis=0), details)


def idtcwt1d(coeffs: DTCoeffs1D, length: int, *,
             order: Tuple[int, int] = (2, 4),
             backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of :func:`dtcwt1d` (exact: each tree is PR; the two
    reconstructions are averaged)."""
    wa, wb = dtcwt_wavelets(*order)
    roll = -_treeB_roll(order[0])
    da = tuple(jnp.real(c) * _SQ2 for c in coeffs.details)
    db = tuple(jnp.imag(c) * _SQ2 for c in coeffs.details)
    ya = sep.idwt1d(Coeffs1D(coeffs.approx[0], da), wa, length,
                    backend=backend)
    lens = level_sizes(length, coeffs.levels)
    a = coeffs.approx[1]
    for j in range(coeffs.levels - 1, 0, -1):
        a = jnp.roll(a, -roll, axis=-1)
        d = jnp.roll(db[j], -roll, axis=-1)
        a = sep.idwt1d(Coeffs1D(a, (d,)), wb, lens[j], backend=backend)
    yb = sep.idwt1d(Coeffs1D(a, db[:1]), wa, length, backend=backend)
    yb = jnp.roll(yb, -1, axis=-1)
    return (ya + yb) * 0.5


# ---------------------------------------------------------------------------
# 2D transform
# ---------------------------------------------------------------------------

class DTCoeffs2D(NamedTuple):
    """``details[j]``: complex (batch + (6, r_j, c_j)) — the six
    oriented subbands of level j+1, ordered (h+, h-, v+, v-, d+, d-)
    where h/v/d follow the framework's real-DWT band convention and
    +/- are the two conjugate-orientation partners.  ``approx`` stacks
    the four (row-tree, col-tree) lowpass combos (AA, AB, BA, BB) on a
    leading axis."""
    approx: jnp.ndarray                       # (4,) + batch + (r_J, c_J)
    details: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def _treeB_roll(L: int) -> int:
    """Samples to roll tree-B outputs per level >= 2: the common-factor
    allpass delays by L + 1/2; the integer part L (= L/2 at the
    decimated rate) must be undone so the inter-tree offset stays at
    half a sample at EVERY level's rate (without this, level 2's
    offset is 2 + 2L ≡ 0 mod 4 for even L and the trees collapse onto
    the same grid — measured: shift-variance worse than a plain DWT)."""
    return L // 2


_COMBOS = ((0, 0), (0, 1), (1, 0), (1, 1))    # (row tree, col tree)


def _real(t):
    # mixing dtype: f32 for bf16/f32 inputs, f64 stays f64 (exact tests)
    return t.astype(jnp.promote_types(t.dtype, jnp.float32))


def _level_fwd_mixed(a: jnp.ndarray, wr: Wavelet, wc: Wavelet,
                     backend) -> Tuple[jnp.ndarray, ...]:
    """One decimated 2D level with per-axis wavelets on (..., r, c):
    returns (a, h, v, d) with the framework's channel convention."""
    batch = a.shape[:-2]
    b = int(np.prod(batch, dtype=np.int64)) if batch else 1
    z = a.reshape((b, 1) + a.shape[-2:])
    z = conv.analysis_pass(z, (wc.dec_lo, wc.dec_hi), axis=-1,
                           backend=backend)
    z = conv.analysis_pass(z, (wr.dec_lo, wr.dec_hi), axis=-2,
                           backend=backend)
    return tuple(z[:, k].reshape(batch + z.shape[-2:]) for k in range(4))


def _level_inv_mixed(bands, wr: Wavelet, wc: Wavelet, out_rc, backend):
    batch = bands[0].shape[:-2]
    b = int(np.prod(batch, dtype=np.int64)) if batch else 1
    z = jnp.stack([t.reshape((b,) + t.shape[-2:]) for t in bands], axis=1)
    z = conv.synthesis_pass(z, (wr.rec_lo, wr.rec_hi), axis=-2,
                            out_len=out_rc[0], backend=backend)
    z = conv.synthesis_pass(z, (wc.rec_lo, wc.rec_hi), axis=-1,
                            out_len=out_rc[1], backend=backend)
    return z[:, 0].reshape(batch + z.shape[-2:])


def _mix(bA, bB, bC, bD):
    """(AA, AB, BA, BB) real bands -> the two conjugate-orientation
    complex bands via the unitary sum/difference mixing."""
    z1 = ((bA - bD) + 1j * (bB + bC)) / _SQ2
    z2 = ((bA + bD) + 1j * (bB - bC)) / _SQ2
    return z1, z2


def _unmix(z1, z2):
    re1, im1 = jnp.real(z1), jnp.imag(z1)
    re2, im2 = jnp.real(z2), jnp.imag(z2)
    return ((re1 + re2) / _SQ2, (im1 + im2) / _SQ2,
            (im1 - im2) / _SQ2, (re2 - re1) / _SQ2)


def dtcwt2d(x: jnp.ndarray, levels: int, *,
            order: Tuple[int, int] = (2, 4),
            backend: Optional[str] = None) -> DTCoeffs2D:
    """Dual-tree complex 2D DWT over the trailing two axes: six
    oriented complex subbands per level at 4x redundancy."""
    wa, wb = dtcwt_wavelets(*order)
    nr, nc = x.shape[-2:]
    if nr % (1 << levels) or nc % (1 << levels):
        raise ValueError(f"shape {(nr, nc)} not divisible by 2^{levels}")
    # level 1: tree A's bank in all four combos, tree-B axes rolled
    approxes = []
    lvl1 = []
    for rt, ct in _COMBOS:
        xi = x
        if rt:
            xi = jnp.roll(xi, 1, axis=-2)
        if ct:
            xi = jnp.roll(xi, 1, axis=-1)
        c = sep.dwt2d(xi, wa, 1, backend=backend)
        approxes.append(c.approx)
        lvl1.append(c.details[0])
    details = [lvl1]
    wsel = (wa, wb)
    roll = -_treeB_roll(order[0])

    def _comp(t, rt, ct):
        # undo the tree-B allpass's integer delay per sharded axis
        if rt:
            t = jnp.roll(t, roll, axis=-2)
        if ct:
            t = jnp.roll(t, roll, axis=-1)
        return t

    for _ in range(1, levels):
        nxt, lvl = [], []
        for (rt, ct), a in zip(_COMBOS, approxes):
            if rt == ct:
                c = sep.dwt2d(a, wsel[rt], 1, backend=backend)
                aa, bands = c.approx, c.details[0]
            else:
                aa, h, v, d = _level_fwd_mixed(a, wsel[rt], wsel[ct],
                                               backend)
                bands = (h, v, d)
            nxt.append(_comp(aa, rt, ct))
            lvl.append(tuple(_comp(t, rt, ct) for t in bands))
        approxes = nxt
        details.append(lvl)

    out = []
    for lvl in details:
        bands6 = []
        for k in range(3):                    # h, v, d
            quad = [_real(lvl[i][k]) for i in range(4)]
            z1, z2 = _mix(*quad)
            bands6.extend([z1, z2])
        out.append(jnp.stack(bands6, axis=-3))
    return DTCoeffs2D(jnp.stack([_real(a) for a in approxes], axis=0),
                      tuple(out))


def idtcwt2d(coeffs: DTCoeffs2D, shape: Tuple[int, int], *,
             order: Tuple[int, int] = (2, 4),
             backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of :func:`dtcwt2d` (exact; averages the four combos)."""
    wa, wb = dtcwt_wavelets(*order)
    rows = level_sizes(shape[0], coeffs.levels)
    cols = level_sizes(shape[1], coeffs.levels)
    wsel = (wa, wb)
    roll = -_treeB_roll(order[0])

    def _uncomp(t, rt, ct):
        if rt:
            t = jnp.roll(t, -roll, axis=-2)
        if ct:
            t = jnp.roll(t, -roll, axis=-1)
        return t

    approxes = [coeffs.approx[i] for i in range(4)]
    for j in range(coeffs.levels - 1, 0, -1):
        z = coeffs.details[j]
        quads = [_unmix(z[..., 2 * k, :, :], z[..., 2 * k + 1, :, :])
                 for k in range(3)]           # h, v, d
        nxt = []
        for i, (rt, ct) in enumerate(_COMBOS):
            bands = tuple(_uncomp(t, rt, ct) for t in
                          (approxes[i], quads[0][i], quads[1][i],
                           quads[2][i]))
            out_rc = (rows[j], cols[j])
            if rt == ct:
                y = sep.idwt2d(
                    Coeffs2D(bands[0], ((bands[1], bands[2], bands[3]),)),
                    wsel[rt], out_rc, backend=backend)
            else:
                y = _level_inv_mixed(bands, wsel[rt], wsel[ct], out_rc,
                                     backend)
            nxt.append(y)
        approxes = nxt
    # level 1: tree A's bank everywhere, then unroll the tree-B axes
    z = coeffs.details[0]
    quads = [_unmix(z[..., 2 * k, :, :], z[..., 2 * k + 1, :, :])
             for k in range(3)]
    ys = []
    for i, (rt, ct) in enumerate(_COMBOS):
        y = sep.idwt2d(
            Coeffs2D(approxes[i], ((quads[0][i], quads[1][i],
                                    quads[2][i]),)),
            wa, shape, backend=backend)
        if rt:
            y = jnp.roll(y, -1, axis=-2)
        if ct:
            y = jnp.roll(y, -1, axis=-1)
        ys.append(y)
    return (ys[0] + ys[1] + ys[2] + ys[3]) * 0.25


def dtcwt_denoise(x: jnp.ndarray, levels: int, beta, *,
                  mode: str = "soft",
                  order: Tuple[int, int] = (2, 4),
                  backend: Optional[str] = None) -> jnp.ndarray:
    """Magnitude thresholding in the dual-tree domain: shrink |c| and
    keep the phase — the near-shift-invariant denoise at 4x redundancy
    instead of the SWT's levels-fold.  ``beta`` is a scalar or a
    per-level sequence (finest first)."""
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    nd = x.ndim
    c = (dtcwt2d(x, levels, order=order, backend=backend) if nd >= 2
         else dtcwt1d(x, levels, order=order, backend=backend))
    betas = (list(beta) if isinstance(beta, (list, tuple))
             else [beta] * levels)
    if len(betas) != levels:
        raise ValueError(f"need {levels} betas, got {len(betas)}")
    details = tuple(
        thr(jnp.abs(z), b) * jnp.exp(1j * jnp.angle(z))
        for z, b in zip(c.details, betas))
    c = type(c)(c.approx, details)
    return (idtcwt2d(c, x.shape[-2:], order=order, backend=backend)
            if nd >= 2
            else idtcwt1d(c, x.shape[-1], order=order, backend=backend))


def dtcwt_auto_denoise(x: jnp.ndarray, levels: int, *, k: float = 3.0,
                       mode: str = "soft",
                       order: Tuple[int, int] = (2, 4),
                       backend: Optional[str] = None) -> jnp.ndarray:
    """Knob-free dual-tree magnitude denoise: the white-noise sigma is
    estimated from the finest complex band's magnitudes (the median of
    |c| of circular complex noise is sigma*sqrt(ln 4)) and every level
    is thresholded at ``k * sigma`` — the orthonormal trees make the
    per-level gains 1, so one threshold serves all levels.  ``k`` is a
    scalar or per-level sequence (finest first)."""
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    nd = x.ndim
    c = (dtcwt2d(x, levels, order=order, backend=backend) if nd >= 2
         else dtcwt1d(x, levels, order=order, backend=backend))
    m1 = jnp.abs(c.details[0])
    sigma = jnp.median(m1) / np.sqrt(np.log(4.0))
    ks = list(k) if isinstance(k, (list, tuple)) else [k] * levels
    if len(ks) != levels:
        raise ValueError(f"need {levels} k values, got {len(ks)}")
    details = tuple(
        thr(jnp.abs(z), kj * sigma) * jnp.exp(1j * jnp.angle(z))
        for z, kj in zip(c.details, ks))
    c = type(c)(c.approx, details)
    return (idtcwt2d(c, x.shape[-2:], order=order, backend=backend)
            if nd >= 2
            else idtcwt1d(c, x.shape[-1], order=order, backend=backend))
