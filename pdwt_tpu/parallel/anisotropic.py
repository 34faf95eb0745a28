"""Spatially sharded fully separable (anisotropic) transform.

The core :mod:`pdwt_tpu.core.anisotropic` transform is ``ndim``
independent passes of the batched-1D engine.  Sharding it spatially is
therefore the 1D story applied per axis: each pass runs the batched-1D
engine on every shard with the periodic padding of the transformed
axis substituted by the ring halo exchange (``ring_wrap_pad``)
when that axis is sharded — the other (possibly sharded) axes simply
ride the batch dimension, with NO communication at all.

Layout: the packed pyramid ``[A_L | D_L | ... | D_1]`` is assembled
OUTSIDE ``shard_map`` by concatenating the globally sharded subband
blocks, so the result is bit-identical (layout included) to
:func:`pdwt_tpu.core.anisotropic.fs_dwt`.  Block boundaries are not in
general shard-aligned, so this packing is a resharding relayout that
XLA lowers to collectives; the conv work itself only ever exchanges
halo rings.  (The reference is single-GPU — src/separable.cu — and has
no anisotropic transform at all; see SURVEY.md §2.2.)

Divisibility: a sharded axis with level ``lv`` needs
``size % (n_shards * 2**lv) == 0`` (decimated blocks must stay
non-ragged across shards); an unsharded axis only needs the core
transform's rules (odd sizes fine).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import separable as sep_core
from ..core.anisotropic import _per_axis_levels, _unpack1d
from ..filters import Wavelet
from .halo import make_pad_fn
from .sharded import _check_div

Levels = Union[int, Sequence[int]]


def _norm_axes(axes: Sequence[Optional[str]], levels: Levels):
    axes = tuple(axes)
    lvls = _per_axis_levels(levels, len(axes))
    if len(lvls) != len(axes):
        raise ValueError(
            f"levels ({len(lvls)} axes) and axes ({len(axes)}) disagree")
    return axes, lvls


def _full_spec(ndim: int, nd: int, data_axis, axes) -> list:
    """Mesh-axis name per array dim: data_axis on dim 0 (if any), the
    per-axis rings on the trailing ``nd`` spatial dims."""
    sp = [None] * ndim
    if data_axis is not None:
        if ndim == nd:
            raise ValueError("data_axis given but input has no batch dim")
        sp[0] = data_axis
    sp[ndim - nd:] = list(axes)
    return sp


def _moved(sp: list, ax: int) -> list:
    """The spec list after ``moveaxis(ax, -1)``."""
    sp = list(sp)
    name = sp.pop(ax)
    sp.append(name)
    return sp


def fs_dwt(x: jnp.ndarray, wav: Wavelet, levels: Levels, mesh: Mesh, *,
           axes: Sequence[Optional[str]],
           data_axis: Optional[str] = None,
           backend: Optional[str] = None) -> jnp.ndarray:
    """Sharded fully separable forward transform over the trailing
    ``len(axes)`` axes.  ``axes[k]`` names the mesh axis the k-th
    spatial dim is sharded over (``None`` = replicated/local).  Returns
    the packed coefficient array, globally identical to the
    single-device :func:`core.anisotropic.fs_dwt`."""
    axes, lvls = _norm_axes(axes, levels)
    nd = len(axes)
    if nd > x.ndim:
        raise ValueError(f"{nd} spatial axes but input is {x.ndim}-D")
    for k, (name, lv) in enumerate(zip(axes, lvls)):
        if name is not None and lv > 0:
            _check_div(f"axis {k}", x.shape[x.ndim - nd + k],
                       mesh.shape[name], lv, swt=False)

    sp = _full_spec(x.ndim, nd, data_axis, axes)
    y = x
    for k, lv in enumerate(lvls):
        if lv == 0:
            continue
        ax = x.ndim - nd + k
        pad_fn = make_pad_fn(dict(mesh.shape), None, axes[k])
        msp = _moved(sp, ax)
        spec = P(*msp)

        def local(xl, lv=lv, pad_fn=pad_fn):
            return sep_core.dwt1d(xl, wav, lv, backend=backend,
                                  pad_fn=pad_fn)

        f = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False)
        c = f(jnp.moveaxis(y, ax, -1))
        # pack OUTSIDE shard_map: subband blocks are globally sharded
        # arrays; the concat is the (XLA-resharded) wavedec layout.
        parts = [c.approx] + [c.details[l] for l in
                              range(len(c.details) - 1, -1, -1)]
        y = jnp.moveaxis(jnp.concatenate(parts, axis=-1), -1, ax)
    return y


def fs_idwt(arr: jnp.ndarray, wav: Wavelet, shape: Sequence[int],
            levels: Levels, mesh: Mesh, *,
            axes: Sequence[Optional[str]],
            data_axis: Optional[str] = None,
            backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of :func:`fs_dwt`; ``shape`` is the original size of the
    trailing spatial axes."""
    axes, lvls = _norm_axes(axes, levels)
    nd = len(axes)
    for k, (name, lv) in enumerate(zip(axes, lvls)):
        if name is not None and lv > 0:
            _check_div(f"axis {k}", shape[k], mesh.shape[name], lv,
                       swt=False)

    sp = _full_spec(arr.ndim, nd, data_axis, axes)
    y = arr
    for k in range(nd - 1, -1, -1):
        lv = lvls[k]
        if lv == 0:
            continue
        ax = arr.ndim - nd + k
        n_sh = mesh.shape[axes[k]] if axes[k] is not None else 1
        local_len = shape[k] // n_sh
        pad_fn = make_pad_fn(dict(mesh.shape), None, axes[k])
        msp = _moved(sp, ax)
        spec = P(*msp)

        def local(cl, local_len=local_len, pad_fn=pad_fn):
            return sep_core.idwt1d(cl, wav, local_len, backend=backend,
                                   pad_fn=pad_fn)

        f = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False)
        # unpack OUTSIDE shard_map (global static slices, the mirror
        # relayout of the forward's pack), then the ring-halo inverse.
        c = _unpack1d(jnp.moveaxis(y, ax, -1), shape[k], lv)
        y = jnp.moveaxis(f(c), -1, ax)
    return y
