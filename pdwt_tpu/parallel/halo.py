"""Ring halo exchange — the distributed form of periodic padding.

The reference is single-GPU: its periodic boundary handling is an index
``mod N`` inside each CUDA kernel (reference: src/separable.cu:111-121,
src/nonseparable.cu:129-137).  When an axis is sharded across devices,
the rows/columns a convolution window needs beyond the local shard live
on ring neighbors, and the periodic wrap is exactly the wrap of the
device ring: the left pad of shard 0 comes from the tail of shard N-1.
``ring_wrap_pad`` implements this with ``lax.ppermute`` neighbor pushes
(NCCL on GPUs); it is the drop-in ``pad_fn`` for the conv passes in
:mod:`pdwt_tpu.core.conv`.

Halo widths larger than the local shard (deep SWT levels, where the
à-trous dilation makes the filter span ``(hlen-1)·2^(level-1)``,
reference: src/separable.cu:414-438) are handled with multiple static
ring hops.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core.conv import wrap_pad


def ring_wrap_pad(
    x: jnp.ndarray,
    axis: int,
    lo: int,
    hi: int,
    *,
    axis_name: str,
    n_shards: int,
) -> jnp.ndarray:
    """Periodic pad of a sharded axis via ring neighbor exchange.

    Must be called inside ``shard_map`` with ``axis_name`` bound; ``x`` is
    the local shard, and the returned array has ``lo`` (``hi``) extra
    elements on the low (high) side fetched from ring neighbors, with the
    global periodic wrap falling out of the ring topology.
    """
    if n_shards == 1:
        return wrap_pad(x, axis, lo, hi)
    n = x.shape[axis % x.ndim]
    left_parts = []
    rem, k = lo, 1
    while rem > 0:
        take = min(rem, n)
        sl = lax.slice_in_dim(x, n - take, n, axis=axis)
        perm = [(j, (j + k) % n_shards) for j in range(n_shards)]
        left_parts.insert(0, lax.ppermute(sl, axis_name, perm))
        rem -= take
        k += 1
    right_parts = []
    rem, k = hi, 1
    while rem > 0:
        take = min(rem, n)
        sl = lax.slice_in_dim(x, 0, take, axis=axis)
        perm = [(j, (j - k) % n_shards) for j in range(n_shards)]
        right_parts.append(lax.ppermute(sl, axis_name, perm))
        rem -= take
        k += 1
    if not left_parts and not right_parts:
        return x
    return jnp.concatenate(left_parts + [x] + right_parts, axis=axis)


def make_pad_fn(mesh_shape: dict, row_axis=None, col_axis=None,
                dep_axis=None):
    """Build a ``pad_fn`` dispatching per spatial axis: ring exchange on
    sharded axes, local periodic wrap otherwise.

    Spatial axes are the trailing dims of the (N, C, *spatial) arrays the
    conv passes operate on (W = -1, H = -2, and for volumes D = -3 via
    ``dep_axis``).
    """

    def pad_fn(arr, axis, lo, hi):
        ax = axis % arr.ndim
        if ax == arr.ndim - 3 and dep_axis is not None:
            return ring_wrap_pad(arr, axis, lo, hi, axis_name=dep_axis,
                                 n_shards=mesh_shape[dep_axis])
        if ax == arr.ndim - 2 and row_axis is not None:
            return ring_wrap_pad(arr, axis, lo, hi, axis_name=row_axis,
                                 n_shards=mesh_shape[row_axis])
        if ax == arr.ndim - 1 and col_axis is not None:
            return ring_wrap_pad(arr, axis, lo, hi, axis_name=col_axis,
                                 n_shards=mesh_shape[col_axis])
        return wrap_pad(arr, axis, lo, hi)

    return pad_fn
