"""Spatially sharded wavelet packet transforms.

The core packet decomposition (:mod:`pdwt_tpu.core.packets`) is one
batched single-level DWT per depth, with all ``fan^j`` tree nodes
stacked on a leading axis.  Sharding it spatially therefore reuses the
sharded single-level machinery verbatim: each depth is ONE
``shard_map``'d batched forward whose periodic padding is the ring
halo exchange, with the node axis riding the (replicated) batch
dimension — communication per depth is exactly the halo of a
single-level DWT, regardless of how many nodes the depth holds.  The
node stack/reshape relayouts happen on the global arrays between
depths (no collectives: the node axis is unsharded).

Best-basis search needs no sharded variant: ``core.packets.wp_costs``
is a jitted reduction over global (sharded) arrays — XLA lowers the
per-node sums to partial reductions + ``psum`` on its own — and the DP
runs on host either way.  Reconstruction substitutes the ring-halo
single-level inverses through ``wp_reconstruct``'s ``inv1_fn``
extension point.

(The reference is single-GPU and has no packets at all; packets are a
beyond-parity feature, see SURVEY.md §2.2 / core/packets.py.)
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
from jax.sharding import Mesh

from ..core.packets import (
    Packets1D,
    Packets2D,
    Packets3D,
    wp_reconstruct as _core_wp_reconstruct,
)
from ..filters import Wavelet
from . import sharded


def wp2d(x: jnp.ndarray, wav: Wavelet, levels: int, mesh: Mesh, *,
         data_axis: Optional[str] = None, row_axis: Optional[str] = None,
         col_axis: Optional[str] = None,
         backend: Optional[str] = None) -> Packets2D:
    """Sharded full 2D packet decomposition: one ring-halo batched
    single-level DWT per depth (node axis = replicated batch)."""
    sharded._validate2d(x, mesh, data_axis, row_axis, col_axis, levels,
                        swt=False)
    batch = x.shape[:-2]
    nodes = [x[..., None, :, :]]
    for _ in range(levels):
        c = sharded.dwt2d(nodes[-1], wav, 1, mesh, data_axis=data_axis,
                          row_axis=row_axis, col_axis=col_axis,
                          backend=backend)
        a = c.approx
        h, v, d = c.details[0]
        n, r, cc = a.shape[-3:]
        stk = jnp.stack([a, h, v, d], axis=-3)
        nodes.append(stk.reshape(batch + (4 * n, r, cc)))
    return Packets2D(tuple(nodes))


def wp1d(x: jnp.ndarray, wav: Wavelet, levels: int, mesh: Mesh, *,
         data_axis: Optional[str] = None, col_axis: Optional[str] = None,
         backend: Optional[str] = None) -> Packets1D:
    """Sharded full 1D packet decomposition over the trailing axis."""
    if col_axis is not None:
        sharded._check_div("signal", x.shape[-1], mesh.shape[col_axis],
                           levels, swt=False)
    batch = x.shape[:-1]
    nodes = [x[..., None, :]]
    for _ in range(levels):
        c = sharded.dwt1d(nodes[-1], wav, 1, mesh, data_axis=data_axis,
                          col_axis=col_axis, backend=backend)
        a, d = c.approx, c.details[0]
        if a.dtype != d.dtype:
            a = a.astype(d.dtype)
        n, ln = a.shape[-2:]
        stk = jnp.stack([a, d], axis=-2)
        nodes.append(stk.reshape(batch + (2 * n, ln)))
    return Packets1D(tuple(nodes))


def wp3d(x: jnp.ndarray, wav: Wavelet, levels: int, mesh: Mesh, *,
         data_axis: Optional[str] = None, dep_axis: Optional[str] = None,
         row_axis: Optional[str] = None, col_axis: Optional[str] = None,
         backend: Optional[str] = None) -> Packets3D:
    """Sharded full 3D packet decomposition (octree): per depth one
    ring-halo batched single-level 3D DWT over (depth, row, col)."""
    batch = x.shape[:-3]
    nodes = [x[..., None, :, :, :]]
    for _ in range(levels):
        c = sharded.dwt3d(nodes[-1], wav, 1, mesh, data_axis=data_axis,
                          dep_axis=dep_axis, row_axis=row_axis,
                          col_axis=col_axis, backend=backend)
        a = c.approx
        dets = c.details[0]
        if a.dtype != dets[0].dtype:
            a = a.astype(dets[0].dtype)
        n, dd, r, cc = a.shape[-4:]
        stk = jnp.stack((a,) + tuple(dets), axis=-4)
        nodes.append(stk.reshape(batch + (8 * n, dd, r, cc)))
    return Packets3D(tuple(nodes))


def _inv1_fn(packets, wav, mesh, axes: dict, backend):
    """Ring-halo batched single-level inverse for wp_reconstruct."""
    if isinstance(packets, Packets3D):
        def inv1(cfs, out_shape):
            return sharded.idwt3d(cfs, wav, out_shape, mesh,
                                  backend=backend, **axes)
    elif isinstance(packets, Packets2D):
        def inv1(cfs, out_shape):
            return sharded.idwt2d(cfs, wav, out_shape, mesh,
                                  backend=backend, **axes)
    else:
        def inv1(cfs, out_shape):
            return sharded.idwt1d(cfs, wav, out_shape[0], mesh,
                                  backend=backend, **axes)
    return inv1


def wp_reconstruct(packets, leaves: Sequence[Tuple[int, int]],
                   wav: Wavelet, mesh: Mesh, *,
                   data_axis: Optional[str] = None,
                   dep_axis: Optional[str] = None,
                   row_axis: Optional[str] = None,
                   col_axis: Optional[str] = None,
                   backend: Optional[str] = None,
                   map_fn=None) -> jnp.ndarray:
    """Sharded pruned-tree reconstruction: the core cover/DP walk with
    every batched single-level inverse replaced by its ring-halo
    sharded counterpart."""
    if isinstance(packets, Packets3D):
        axes = dict(data_axis=data_axis, dep_axis=dep_axis,
                    row_axis=row_axis, col_axis=col_axis)
    elif isinstance(packets, Packets2D):
        axes = dict(data_axis=data_axis, row_axis=row_axis,
                    col_axis=col_axis)
    else:
        axes = dict(data_axis=data_axis, col_axis=col_axis)
    return _core_wp_reconstruct(
        packets, leaves, wav, map_fn=map_fn,
        inv1_fn=_inv1_fn(packets, wav, mesh, axes, backend))


def _iwp_full(container, fan: int, sd: int, leaf_nodes, wav, shape, mesh,
              axes: dict, backend):
    """Full-tree inverse = wp_reconstruct over the complete deepest
    cover; the root entry is a shape-only placeholder (only its shape
    feeds the per-depth size tables)."""
    import jax

    n_nodes = leaf_nodes.shape[-(sd + 1)]
    levels = int(round(math.log(n_nodes, fan)))
    if fan ** levels != n_nodes:
        raise ValueError(f"node axis {n_nodes} is not a power of {fan}")
    root = jax.ShapeDtypeStruct(
        leaf_nodes.shape[:-(sd + 1)] + (1,) + tuple(shape),
        leaf_nodes.dtype)
    pk = container((root,) + (None,) * (levels - 1) + (leaf_nodes,))
    leaves = [(levels, i) for i in range(n_nodes)]
    return wp_reconstruct(pk, leaves, wav, mesh, backend=backend, **axes)


def iwp1d(leaf_nodes, wav: Wavelet, length: int, mesh: Mesh, *,
          data_axis: Optional[str] = None,
          col_axis: Optional[str] = None,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Sharded inverse of the FULL 1D packet decomposition."""
    return _iwp_full(Packets1D, 2, 1, leaf_nodes, wav, (length,), mesh,
                     dict(data_axis=data_axis, col_axis=col_axis), backend)


def iwp2d(leaf_nodes: jnp.ndarray, wav: Wavelet,
          shape: Tuple[int, int], mesh: Mesh, *,
          data_axis: Optional[str] = None,
          row_axis: Optional[str] = None,
          col_axis: Optional[str] = None,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Sharded inverse of the FULL 2D packet decomposition from
    ``packets.nodes[-1]``."""
    return _iwp_full(Packets2D, 4, 2, leaf_nodes, wav, shape, mesh,
                     dict(data_axis=data_axis, row_axis=row_axis,
                          col_axis=col_axis), backend)


def iwp3d(leaf_nodes: jnp.ndarray, wav: Wavelet,
          shape: Tuple[int, int, int], mesh: Mesh, *,
          data_axis: Optional[str] = None,
          dep_axis: Optional[str] = None,
          row_axis: Optional[str] = None,
          col_axis: Optional[str] = None,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Sharded inverse of the FULL 3D packet decomposition."""
    return _iwp_full(Packets3D, 8, 3, leaf_nodes, wav, shape, mesh,
                     dict(data_axis=data_axis, dep_axis=dep_axis,
                          row_axis=row_axis, col_axis=col_axis), backend)
