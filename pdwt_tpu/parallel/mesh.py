"""Device mesh construction for the (data, row, col) sharding layout."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(**kwargs) -> None:
    """Multi-host initialization: same SPMD program on every host, global
    meshes over all chips (SURVEY.md §2.3).  Thin wrapper so applications
    don't import jax.distributed directly; no-op if already initialized.

    Pass ``coordinator_address=, num_processes=, process_id=`` unless a
    cluster environment provides them.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def make_mesh(
    shape: Sequence[int],
    axis_names: Tuple[str, ...] = ("data", "row", "col"),
    *,
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``shape`` entries of -1 are inferred (at most one).  Devices fill
    the mesh in ``jax.devices()`` order, the last axis varying fastest.
    """
    devices = list(devices if devices is not None else jax.devices())
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = int(np.prod([s for s in shape if s != -1], dtype=np.int64))
    if -1 in shape:
        if len(devices) % known != 0:
            raise ValueError(
                f"{len(devices)} devices not divisible by {known}")
        shape[shape.index(-1)] = len(devices) // known
    total = int(np.prod(shape, dtype=np.int64))
    if total != len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {total} devices, "
            f"have {len(devices)}")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names[: len(shape)])
