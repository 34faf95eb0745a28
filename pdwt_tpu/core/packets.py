"""Wavelet packet transforms with Coifman-Wickerhauser best-basis search.

Beyond the reference (pierrepaleo/PDWT stops at the pyramid DWT/SWT —
packets generalize it by also splitting the detail subbands, reference:
src/separable.cu:91-209 computes only the approximation recursion).

Formulation: the packet tree is NOT a tree of kernel calls.
At depth ``j`` all ``4^j`` (2D) / ``2^j`` (1D) nodes are stacked on a
leading axis and transformed by ONE batched single-level call — the
node axis rides the level's batch dimension, so a full-depth packet
decomposition costs ``levels`` batched level calls total, identical
per-pixel work to the pyramid DWT.

Node ordering is natural (Paley): child ``k`` of node ``i`` at depth
``j`` is node ``4*i + k`` at depth ``j+1``, with ``k`` in
(a, h, v, d) = (0, 1, 2, 3) for 2D and (a, d) = (0, 1) for 1D — the
2D subband convention (H = highpass along rows) is core/conv.py's.

Best basis (Coifman & Wickerhauser 1992): additive cost per node,
bottom-up dynamic programming picking each node either as a leaf or as
the union of its children's best bases.  Costs are computed on-device
in one jitted program; the O(4^L) DP runs on host (the selection is a
static python structure, so reconstruction stays jittable).  For
orthogonal wavelets every basis in the tree conserves energy, making
the unnormalized Shannon cost -sum x^2 ln x^2 comparable across bases;
for biorthogonal banks the comparison is approximate.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..filters import Wavelet
from .separable import dwt1d, dwt2d, idwt1d, idwt2d, Coeffs1D, Coeffs2D
from .shapes import level_sizes


class Packets1D(NamedTuple):
    """Full packet tree of a 1D signal: ``nodes[j]`` has shape
    ``batch + (2**j, n_j)`` — depth 0 is the signal itself."""
    nodes: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


class Packets2D(NamedTuple):
    """Full packet tree of an image: ``nodes[j]`` has shape
    ``batch + (4**j, r_j, c_j)`` — depth 0 is the image itself."""
    nodes: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


class Packets3D(NamedTuple):
    """Full packet tree of a volume: ``nodes[j]`` has shape
    ``batch + (8**j, d_j, r_j, c_j)`` — depth 0 is the volume itself.
    Child ordering within a split: (aaa,) + DETAIL_KEYS_3D."""
    nodes: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


def _geom(packets):
    """(spatial ndim, fan-out, node axis) for a packet pytree."""
    if isinstance(packets, Packets3D):
        return 3, 8, -4
    if isinstance(packets, Packets2D):
        return 2, 4, -3
    if isinstance(packets, Packets1D):
        return 1, 2, -2
    raise TypeError(f"expected a Packets pytree, got {type(packets)}")


def wp2d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets2D:
    """Full 2D wavelet packet decomposition over the trailing two axes
    (leading axes are batch).  One batched single-level DWT per depth."""
    batch = x.shape[:-2]
    nodes = [x[..., None, :, :]]
    for j in range(levels):
        cur = nodes[-1]
        c = dwt2d(cur, wav, 1, backend=backend)
        a = c.approx
        h, v, d = c.details[0]
        n, r, cc = a.shape[-3:]
        stk = jnp.stack([a, h, v, d], axis=-3)  # (..., n, 4, r, c)
        nodes.append(stk.reshape(batch + (4 * n, r, cc)))
    return Packets2D(tuple(nodes))


def iwp2d(leaf_nodes: jnp.ndarray, wav: Wavelet,
          shape: Tuple[int, int], *,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of the FULL packet decomposition from the deepest node
    array (``packets.nodes[-1]``); ``shape`` is the original (rows,
    cols).  For a pruned (best-basis) tree use :func:`wp_reconstruct`."""
    x = leaf_nodes
    levels = int(round(math.log(x.shape[-3], 4)))
    if 4 ** levels != x.shape[-3]:
        raise ValueError(f"node axis {x.shape[-3]} is not a power of 4")
    rows = level_sizes(shape[0], levels)
    cols = level_sizes(shape[1], levels)
    batch = x.shape[:-3]
    for j in range(levels - 1, -1, -1):
        n, r, c = x.shape[-3:]
        g = x.reshape(batch + (n // 4, 4, r, c))
        cfs = Coeffs2D(g[..., 0, :, :],
                       ((g[..., 1, :, :], g[..., 2, :, :],
                         g[..., 3, :, :]),))
        x = idwt2d(cfs, wav, (rows[j], cols[j]), backend=backend)
    return x[..., 0, :, :]


def wp3d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets3D:
    """Full 3D wavelet packet decomposition over the trailing three
    axes — one batched single-level 3D DWT per depth (node axis =
    batch, 8 children per node)."""
    from .separable3d import dwt3d

    batch = x.shape[:-3]
    nodes = [x[..., None, :, :, :]]
    for j in range(levels):
        cur = nodes[-1]
        c = dwt3d(cur, wav, 1, backend=backend)
        a = c.approx
        dets = c.details[0]
        if a.dtype != dets[0].dtype:
            a = a.astype(dets[0].dtype)
        n, dd, r, cc = a.shape[-4:]
        stk = jnp.stack((a,) + tuple(dets), axis=-4)
        nodes.append(stk.reshape(batch + (8 * n, dd, r, cc)))
    return Packets3D(tuple(nodes))


def iwp3d(leaf_nodes: jnp.ndarray, wav: Wavelet,
          shape: Tuple[int, int, int], *,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of the full 3D packet decomposition from
    ``packets.nodes[-1]``."""
    from .separable3d import Coeffs3D, idwt3d

    x = leaf_nodes
    levels = int(round(math.log(x.shape[-4], 8)))
    if 8 ** levels != x.shape[-4]:
        raise ValueError(f"node axis {x.shape[-4]} is not a power of 8")
    deps = level_sizes(shape[0], levels)
    rows = level_sizes(shape[1], levels)
    cols = level_sizes(shape[2], levels)
    batch = x.shape[:-4]
    for j in range(levels - 1, -1, -1):
        n, dd, r, c = x.shape[-4:]
        g = x.reshape(batch + (n // 8, 8, dd, r, c))
        cfs = Coeffs3D(g[..., 0, :, :, :],
                       (tuple(g[..., k, :, :, :] for k in range(1, 8)),))
        x = idwt3d(cfs, wav, (deps[j], rows[j], cols[j]), backend=backend)
    return x[..., 0, :, :, :]


def wp1d(x: jnp.ndarray, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets1D:
    """Full 1D wavelet packet decomposition over the trailing axis."""
    batch = x.shape[:-1]
    nodes = [x[..., None, :]]
    for j in range(levels):
        cur = nodes[-1]
        c = dwt1d(cur, wav, 1, backend=backend)
        a, d = c.approx, c.details[0]
        if a.dtype != d.dtype:
            a = a.astype(d.dtype)
        n, ln = a.shape[-2:]
        stk = jnp.stack([a, d], axis=-2)
        nodes.append(stk.reshape(batch + (2 * n, ln)))
    return Packets1D(tuple(nodes))


def iwp1d(leaf_nodes: jnp.ndarray, wav: Wavelet, length: int, *,
          backend: Optional[str] = None) -> jnp.ndarray:
    """Inverse of the full 1D packet decomposition from
    ``packets.nodes[-1]``."""
    x = leaf_nodes
    levels = int(round(math.log2(x.shape[-2])))
    if 2 ** levels != x.shape[-2]:
        raise ValueError(f"node axis {x.shape[-2]} is not a power of 2")
    lens = level_sizes(length, levels)
    batch = x.shape[:-2]
    for j in range(levels - 1, -1, -1):
        n, ln = x.shape[-2:]
        g = x.reshape(batch + (n // 2, 2, ln))
        cfs = Coeffs1D(g[..., 0, :], (g[..., 1, :],))
        x = idwt1d(cfs, wav, lens[j], backend=backend)
    return x[..., 0, :]


# ---------------------------------------------------------------------------
# best basis
# ---------------------------------------------------------------------------

_EPS = 1e-30


def _node_costs(nodes: jnp.ndarray, node_axis: int, cost: str, thresh):
    """Additive cost per node: reduce every axis except ``node_axis``."""
    x = nodes.astype(jnp.float32)
    axes = tuple(i for i in range(x.ndim)
                 if i != node_axis % x.ndim)
    if cost == "shannon":
        e = x * x
        return -jnp.sum(e * jnp.log(e + _EPS), axis=axes)
    if cost == "logenergy":
        return jnp.sum(jnp.log(x * x + _EPS), axis=axes)
    if cost == "l1":
        return jnp.sum(jnp.abs(x), axis=axes)
    if cost == "threshold":
        return jnp.sum((jnp.abs(x) > thresh).astype(jnp.float32), axis=axes)
    raise ValueError(f"unknown cost {cost!r}")


@functools.lru_cache(maxsize=None)
def _cost_prog(axis: int, cost: str):
    # one jitted program per (geometry, cost) — reused across calls so
    # repeated best_basis() invocations never retrace (thresh is traced)
    def prog(nodes, thresh):
        return [_node_costs(nd, axis, cost, thresh) for nd in nodes]

    return jax.jit(prog)


def wp_costs(packets, cost: str = "shannon", thresh: float = 0.0):
    """Per-depth per-node additive costs, one jitted program (cached
    per tree geometry and cost function)."""
    _, _, axis = _geom(packets)
    if cost not in ("shannon", "logenergy", "l1", "threshold"):
        raise ValueError(f"unknown cost {cost!r}")
    return _cost_prog(axis, cost)(list(packets.nodes),
                                  jnp.float32(thresh))


def best_basis(packets, cost: str = "shannon",
               thresh: float = 0.0) -> Tuple[Tuple[Tuple[int, int], ...],
                                             float]:
    """Coifman-Wickerhauser best-basis search.  Returns
    ``(leaves, total_cost)`` with ``leaves`` a static tuple of
    ``(depth, node_index)`` forming a disjoint cover of the root —
    pass to :func:`wp_reconstruct`.  ``cost`` is ``"shannon"``
    (-sum x^2 ln x^2), ``"logenergy"``, ``"l1"``, or ``"threshold"``
    (count above ``thresh``); costs aggregate over any batch axes (one
    shared basis for the whole batch)."""
    _, fan, _ = _geom(packets)
    costs = [np.asarray(c, np.float64) for c in wp_costs(
        packets, cost, thresh)]
    levels = packets.levels
    best = [None] * (levels + 1)
    split = [None] * (levels + 1)
    best[levels] = costs[levels]
    split[levels] = np.zeros_like(costs[levels], dtype=bool)
    for j in range(levels - 1, -1, -1):
        child_sum = best[j + 1].reshape(-1, fan).sum(axis=1)
        split[j] = child_sum < costs[j]
        best[j] = np.where(split[j], child_sum, costs[j])
    leaves = []

    def walk(j, i):
        if split[j][i]:
            for k in range(fan):
                walk(j + 1, fan * i + k)
        else:
            leaves.append((j, int(i)))

    walk(0, 0)
    return tuple(leaves), float(best[0][0])


def wp_reconstruct(packets, leaves: Sequence[Tuple[int, int]],
                   wav: Wavelet, *,
                   backend: Optional[str] = None,
                   map_fn=None, inv1_fn=None) -> jnp.ndarray:
    """Reconstruct the signal/image from a pruned packet tree: the
    coefficients of the ``leaves`` cover (as from :func:`best_basis`),
    optionally transformed by ``map_fn(node_array, depth, index)`` —
    e.g. a threshold — before synthesis.  The leaf set is static, so
    the whole reconstruction is one jittable program: per depth, every
    completed sibling group (pair/quad/octet in 1D/2D/3D) is synthesized by one
    batched single-level inverse.

    ``inv1_fn(coeffs, out_shape)`` overrides the batched single-level
    inverse — the extension point the spatially sharded composition
    (:mod:`pdwt_tpu.parallel.packets`) uses to substitute the ring-halo
    inverses; ``coeffs`` is the matching ``Coeffs1D/2D/3D``."""
    sd, fan, axis = _geom(packets)
    levels = packets.levels
    # per-axis size tables at every depth
    sizes = [level_sizes(n, levels)
             for n in packets.nodes[0].shape[-sd:]]

    def sl(nd, i):
        return nd[(Ellipsis, i) + (slice(None),) * sd]

    def default_inv1(cfs, out_shape):
        if sd == 3:
            from .separable3d import idwt3d

            return idwt3d(cfs, wav, out_shape, backend=backend)
        if sd == 2:
            return idwt2d(cfs, wav, out_shape, backend=backend)
        return idwt1d(cfs, wav, out_shape[0], backend=backend)

    inv1 = inv1_fn if inv1_fn is not None else default_inv1

    def inv_level(kids, j):
        n = kids.shape[axis]
        batch = kids.shape[:axis]
        g = kids.reshape(batch + (n // fan, fan) + kids.shape[-sd:])
        band = lambda k: g[(Ellipsis, k) + (slice(None),) * sd]
        out_shape = tuple(s[j - 1] for s in sizes)
        if sd == 3:
            from .separable3d import Coeffs3D

            cfs = Coeffs3D(band(0), (tuple(band(k) for k in range(1, 8)),))
        elif sd == 2:
            cfs = Coeffs2D(band(0), ((band(1), band(2), band(3)),))
        else:
            cfs = Coeffs1D(band(0), (band(1),))
        return inv1(cfs, out_shape)

    cover = sorted(set((int(j), int(i)) for j, i in leaves))
    cur = {}
    for j, i in cover:
        if not 0 <= j <= levels:
            raise ValueError(f"leaf depth {j} outside tree of {levels}")
        val = sl(packets.nodes[j], i)
        cur.setdefault(j, {})[i] = (val if map_fn is None
                                    else map_fn(val, j, i))
    for j in range(levels, 0, -1):
        layer = cur.pop(j, {})
        if not layer:
            continue
        idx = sorted(layer)
        parents = sorted(set(i // fan for i in idx))
        want = [fan * p + k for p in parents for k in range(fan)]
        if idx != want:
            raise ValueError(f"leaves do not tile depth {j}: {idx}")
        kids = jnp.stack([layer[i] for i in idx], axis=axis)
        vals = inv_level(kids, j)
        up = cur.setdefault(j - 1, {})
        for t, p in enumerate(parents):
            if p in up:
                raise ValueError(f"overlapping cover at depth {j-1}/{p}")
            up[p] = sl(vals, t)
    top = cur.get(0, {})
    if sorted(top) != [0]:
        raise ValueError("leaves do not cover the root")
    return top[0]
