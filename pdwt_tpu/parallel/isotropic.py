"""Spatially sharded starlet (isotropic à-trous) transform.

The starlet is undecimated, so the sharding story is the SWT's: every
spatial axis may be sharded (size % n_shards == 0), the B3 smoothing's
periodic padding is substituted by the multi-hop ring halo exchange
on sharded axes (``make_pad_fn``), and the detail planes come
back with the input's sharding — bit-identical to the single-device
:func:`pdwt_tpu.core.starlet.starlet`.  (The reference is single-GPU
and has no isotropic transform; see SURVEY.md §2.2.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

# NB: core re-exports the starlet FUNCTION, shadowing the submodule as
# a package attribute — import from the module path directly
from ..core.starlet import StarletCoeffs
from ..core.starlet import istarlet as _istarlet_core
from ..core.starlet import starlet as _starlet_core
from .halo import make_pad_fn


def _spec(x_ndim: int, sd: int, data_axis, spatial_axes) -> P:
    sp = [None] * x_ndim
    if data_axis is not None:
        sp[0] = data_axis
    for i, name in enumerate(spatial_axes):
        if name is not None:
            sp[x_ndim - sd + i] = name
    return P(*sp)


def _pad_kw(sd: int, spatial_axes) -> dict:
    # make_pad_fn names the trailing conv dims (W=-1, H=-2, D=-3); for
    # ndim=1 the core adds a dummy row axis, so the single spatial axis
    # is always the last (-1) dim
    names = list(spatial_axes)
    kw = {"col_axis": names[-1]}
    if sd >= 2:
        kw["row_axis"] = names[-2]
    if sd == 3:
        kw["dep_axis"] = names[-3]
    return kw


def _validate(x, mesh: Mesh, sd: int, data_axis, spatial_axes):
    if len(spatial_axes) != sd:
        raise ValueError(f"need {sd} spatial axis names, got "
                         f"{len(spatial_axes)}")
    for i, name in enumerate(spatial_axes):
        if name is None:
            continue
        n = x.shape[x.ndim - sd + i]
        shards = mesh.shape[name]
        if n % shards:
            raise ValueError(
                f"spatial axis {i} (size {n}) not divisible by "
                f"{shards} shards on mesh axis {name!r}")
    if data_axis is not None and x.shape[0] % mesh.shape[data_axis]:
        raise ValueError("batch axis not divisible by data shards")


def starlet(x, levels: int, mesh: Mesh, *,
            data_axis: Optional[str] = None,
            spatial_axes: Tuple[Optional[str], ...] = (None, None),
            gen: int = 2,
            backend: Optional[str] = None) -> StarletCoeffs:
    """Sharded isotropic à-trous decomposition; ``spatial_axes`` names
    the mesh axis (or None) per trailing spatial dim of ``x``."""
    sd = len(spatial_axes)
    _validate(x, mesh, sd, data_axis, spatial_axes)
    spec = _spec(x.ndim, sd, data_axis, spatial_axes)
    pad_fn = make_pad_fn(dict(mesh.shape), **_pad_kw(sd, spatial_axes))
    be = backend or "fma"

    def local(xl):
        return _starlet_core(xl, levels, ndim=sd, gen=gen,
                                 backend=be, pad_fn=pad_fn)

    f = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                      check_vma=False)
    return f(x)


def istarlet(coeffs: StarletCoeffs, mesh: Mesh, *,
             data_axis: Optional[str] = None,
             spatial_axes: Tuple[Optional[str], ...] = (None, None),
             gen: int = 2,
             backend: Optional[str] = None):
    """Sharded inverse of :func:`starlet` (same axes/gen)."""
    sd = len(spatial_axes)
    a = coeffs.approx
    _validate(a, mesh, sd, data_axis, spatial_axes)
    spec = _spec(a.ndim, sd, data_axis, spatial_axes)
    pad_fn = make_pad_fn(dict(mesh.shape), **_pad_kw(sd, spatial_axes))
    be = backend or "fma"

    def local(cl):
        return _istarlet_core(cl, ndim=sd, gen=gen, backend=be,
                                  pad_fn=pad_fn)

    f = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                      check_vma=False)
    return f(coeffs)
