"""Device-mesh helpers for the sharded registration pipeline.

The reference's only parallelism is a host process pool over keypoints
(shot_parallelization.py:31).  The device equivalent is a 1-D device mesh over
the *point/keypoint axis* (SURVEY.md §5 "long-context" row): keypoint blocks
are data-parallel for descriptors, ref-descriptor tiles ride a device ring for
matching, and RANSAC/ICP reductions are ``psum`` trees.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

POINTS_AXIS = "points"


def make_mesh(n_devices: int = 0, axis: str = POINTS_AXIS) -> Mesh:
    """1-D mesh over up to ``n_devices`` visible devices (0 = all).

    The axis name must be ``POINTS_AXIS``: every shard_map/PartitionSpec in
    ``parallel.sharded`` binds that name, so a mesh built with any other axis
    would make every sharded stage raise an unbound-axis error deep inside a
    traced program (ADVICE r2 #2) — fail loudly here instead."""
    if axis != POINTS_AXIS:
        raise ValueError(
            f"mesh axis must be {POINTS_AXIS!r} (the name every sharded stage "
            f"binds); got {axis!r}"
        )
    devices = jax.devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple; returns (padded, original_len)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(np.asarray(x), widths), n


def _put(x, sharding: NamedSharding):
    """device_put that also works when the sharding spans processes: every
    process passes the SAME full host array and keeps only its addressable
    shards (``make_array_from_callback``)."""
    if jax.process_count() > 1:
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
    return jax.device_put(x, sharding)


def shard_rows(x, mesh: Mesh, axis: str = POINTS_AXIS):
    """Place ``x`` row-sharded over the mesh (first axis)."""
    spec = P(axis, *([None] * (np.ndim(x) - 1)))
    return _put(x, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh):
    return _put(x, NamedSharding(mesh, P()))


def host_array(x) -> np.ndarray:
    """Global jax.Array → host NumPy array, multi-process safe.

    Single-process (all shards addressable): plain ``np.asarray`` — no copy
    overhead beyond the usual device→host transfer.  Multi-process (row
    shards live on other hosts): all-gather across processes first
    (``multihost_utils.process_allgather``), so every host returns the same
    full array — the contract the host-side pipeline logic (match filtering,
    RANSAC inputs) relies on."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
