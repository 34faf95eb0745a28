"""Fully separable (anisotropic / hyperbolic) wavelet transform.

Beyond the reference: PDWT only implements the square Mallat recursion
(same level count on both axes, reference: src/separable.cu:91-209).
Here each spatial axis gets its own INDEPENDENT multi-level 1D wavedec
— the tensor-product ("fully separable", pywt's ``fswavedecn``) basis.
This matters for anisotropic data: tomography stacks whose depth
resolution differs from the in-plane resolution, sinograms (angle vs
detector), seismic panels.

Formulation: the per-axis operators commute, so the whole
transform is ``ndim`` passes of the batched-1D engine — each pass
transforms EVERY line along one axis at once (all other axes ride the
batch dimension), then packs the
pyramid into one contiguous array in wavedec order
``[A_L | D_L | D_{L-1} | ... | D_1]`` along that axis.  Packing is a
static relayout; the next axis' transform is line-wise independent of
it.  Everything is static-shaped, jit/grad-safe.

Coefficient container: ONE dense array (same rank as the input), plus
the static ``(shape, levels)`` pair needed to unpack — use
:func:`fs_slices` to address individual (per-axis level) blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import jax.numpy as jnp

from ..filters import Wavelet
from .modes import level_sizes as _mode_sizes
from .modes import per_axis
from .separable import Coeffs1D, dwt1d, idwt1d
from .shapes import level_sizes

Levels = Union[int, Sequence[int]]


def _per_axis_levels(levels: Levels, ndim_spatial: Optional[int]):
    if isinstance(levels, int):
        if ndim_spatial is None:
            raise ValueError("scalar levels needs ndim_spatial")
        return (levels,) * ndim_spatial
    return tuple(int(l) for l in levels)


def _axis_blocks(n: int, lv: int, hlen: int = 2,
                 mode: str = "periodization") -> Tuple[int, ...]:
    """Packed block lengths along one axis, coarsest first:
    (s_L, s_L, s_{L-1}, ..., s_1).  Non-periodization modes follow the
    pywt size rule, which depends on the filter length."""
    s = (level_sizes(n, lv) if mode == "periodization"
         else _mode_sizes(n, lv, hlen, mode))
    return (s[lv],) + tuple(s[l] for l in range(lv, 0, -1))


def fs_slices(shape: Sequence[int], levels: Levels, *,
              mode="periodization", hlen: Optional[int] = None
              ) -> Tuple[Dict[str, slice], ...]:
    """Per-axis block slices of the packed array: key ``"a"`` is the
    depth-``L`` approximation block, ``"d<l>"`` the level-``l`` detail
    block (l = 1 is finest).  The block of coefficients that is
    approximation along every axis is
    ``arr[..., sl[0]['a'], sl[1]['a'], ...]``."""
    lvls = _per_axis_levels(levels, len(shape))
    modes_ax = per_axis(mode, len(shape))
    if hlen is None:
        if any(m != "periodization" for m in modes_ax):
            raise ValueError(
                "non-periodization block sizes depend on the filter "
                "length — pass hlen= (the wavelet's .hlen)")
        hlen = 2  # unused by the periodization size rule
    out = []
    for n, lv, m in zip(shape, lvls, modes_ax):
        blocks = _axis_blocks(n, lv, hlen, m)
        keys = ["a"] + [f"d{l}" for l in range(lv, 0, -1)]
        d, pos = {}, 0
        for k, b in zip(keys, blocks):
            d[k] = slice(pos, pos + b)
            pos += b
        out.append(d)
    return tuple(out)


def _pack1d(c: Coeffs1D) -> jnp.ndarray:
    parts = [c.approx] + [c.details[l] for l in
                          range(len(c.details) - 1, -1, -1)]
    return jnp.concatenate(parts, axis=-1)


def _unpack1d(arr: jnp.ndarray, n: int, lv: int, hlen: int = 2,
              mode: str = "periodization") -> Coeffs1D:
    blocks = _axis_blocks(n, lv, hlen, mode)
    pos = 0
    parts = []
    for b in blocks:
        parts.append(arr[..., pos:pos + b])
        pos += b
    # parts = [A_L, D_L, ..., D_1] -> details finest-first
    return Coeffs1D(parts[0], tuple(parts[1:][::-1]))


def fs_dwt(x: jnp.ndarray, wav: Wavelet, levels: Levels, *,
           ndim_spatial: Optional[int] = None,
           backend: Optional[str] = None,
           mode="periodization") -> jnp.ndarray:
    """Fully separable forward transform over the trailing
    ``len(levels)`` axes (or ``ndim_spatial`` with a scalar ``levels``;
    a per-axis level of 0 leaves that axis untransformed).  Returns the
    packed coefficient array (may be slightly larger than the input for
    odd sizes — block sizes from :func:`fs_slices`)."""
    lvls = _per_axis_levels(levels, ndim_spatial)
    nd = len(lvls)
    modes_ax = per_axis(mode, nd)
    if nd > x.ndim:
        raise ValueError(f"{nd} spatial axes but input is {x.ndim}-D")
    y = x
    for k, lv in enumerate(lvls):
        if lv == 0:
            continue
        axis = k - nd  # negative index among the trailing axes
        y = jnp.moveaxis(y, axis, -1)
        y = _pack1d(dwt1d(y, wav, lv, backend=backend, mode=modes_ax[k]))
        y = jnp.moveaxis(y, -1, axis)
    return y


def fs_idwt(arr: jnp.ndarray, wav: Wavelet, shape: Sequence[int],
            levels: Levels, *,
            backend: Optional[str] = None,
            mode="periodization") -> jnp.ndarray:
    """Inverse of :func:`fs_dwt`; ``shape`` is the original size of the
    trailing spatial axes."""
    lvls = _per_axis_levels(levels, len(shape))
    nd = len(lvls)
    modes_ax = per_axis(mode, nd)
    y = arr
    for k in range(nd - 1, -1, -1):
        lv = lvls[k]
        if lv == 0:
            continue
        axis = k - nd
        y = jnp.moveaxis(y, axis, -1)
        y = idwt1d(_unpack1d(y, shape[k], lv, wav.hlen, modes_ax[k]),
                   wav, shape[k], backend=backend, mode=modes_ax[k])
        y = jnp.moveaxis(y, -1, axis)
    return y
