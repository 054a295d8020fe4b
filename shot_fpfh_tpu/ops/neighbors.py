"""Fixed-shape neighbor search: the batched replacement for ``sklearn.neighbors.KDTree``.

The reference calls ``KDTree.query`` / ``query_radius`` at every pipeline stage
(8 import sites — SURVEY.md §1 L1'), producing ragged object arrays.  On the device we
invert the design: every query returns a fixed-``k`` padded index matrix plus a
validity mask, and the distance computation is a tiled matmul
(``‖q−p‖² = ‖q‖² + ‖p‖² − 2 q·p``) followed by ``top_k``.

Brute force is exact and matmul-friendly; it is the v1 engine (SURVEY.md §7 build
order step 2).  A grid-hash engine for ~1M-point clouds plugs in behind the
same API (see ``grid_hash.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Upper bound on elements of one (query_chunk x N) distance tile: ~64M f32 = 256 MB device memory.
_MAX_TILE_ELEMS = 1 << 26


class Neighborhoods(NamedTuple):
    """Padded neighborhoods: ``idx``/``dist`` are ``(Q, K)``; ``mask`` flags real
    neighbors.  Invalid slots have ``idx == 0`` (safe to gather) and
    ``dist == inf``."""

    idx: jnp.ndarray  # (Q, K) int32
    dist: jnp.ndarray  # (Q, K) float32
    mask: jnp.ndarray  # (Q, K) bool

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask, axis=-1)


def _sq_dists(queries: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """(Qc, N) squared distances via the matmul expansion (matmul path)."""
    qn = jnp.sum(queries * queries, axis=-1, keepdims=True)
    pn = jnp.sum(points * points, axis=-1)[None, :]
    cross = queries @ points.T
    return jnp.maximum(qn + pn - 2.0 * cross, 0.0)


def _query_chunk_size(n_points: int) -> int:
    return max(1, min(4096, _MAX_TILE_ELEMS // max(n_points, 1)))


def _chunked_over_queries(fn, queries: jnp.ndarray, chunk: int):
    """Apply ``fn`` to query chunks with static shapes; pads Q to a multiple."""
    q = queries.shape[0]
    n_chunks = -(-q // chunk)
    padded = n_chunks * chunk
    qpad = jnp.pad(queries, ((0, padded - q), (0, 0)))
    out = jax.lax.map(fn, qpad.reshape(n_chunks, chunk, -1))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((padded,) + x.shape[2:])[:q], out
    )


@functools.partial(jax.jit, static_argnames=("k",))
def knn(queries: jnp.ndarray, points: jnp.ndarray, k: int) -> Neighborhoods:
    """Exact k-nearest-neighbors (replaces ``KDTree.query(q, k)``).

    If the cloud has fewer than ``k`` points the tail is masked out.
    """
    queries = jnp.asarray(queries, jnp.float32)
    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]
    k_eff = min(k, n)

    def one_chunk(qc):
        d2 = _sq_dists(qc, points)
        neg, idx = jax.lax.top_k(-d2, k_eff)
        return idx.astype(jnp.int32), -neg

    chunk = _query_chunk_size(n)
    idx, d2 = _chunked_over_queries(one_chunk, queries, chunk)
    if k_eff < k:
        pad = ((0, 0), (0, k - k_eff))
        idx = jnp.pad(idx, pad)
        d2 = jnp.pad(d2, pad, constant_values=jnp.inf)
    mask = jnp.isfinite(d2)
    # Exact distances for the selected neighbors (the matmul expansion loses
    # precision for very close pairs).
    diff = queries[:, None, :] - points[jnp.where(mask, idx, 0)]
    dist = jnp.where(mask, jnp.linalg.norm(diff, axis=-1), jnp.inf)
    return Neighborhoods(jnp.where(mask, idx, 0), dist, mask)


@functools.partial(jax.jit, static_argnames=("k_max",))
def radius_search(
    queries: jnp.ndarray, points: jnp.ndarray, radius, k_max: int
) -> Neighborhoods:
    """All neighbors within ``radius``, capped at the ``k_max`` nearest
    (replaces ``KDTree.query_radius``).

    ``k_max`` is the fixed-shape cap (SURVEY.md §7 hard part 1): choose it above
    the true maximum neighborhood size to make the result exact; use
    ``radius_count`` to validate a cap choice.
    """
    queries = jnp.asarray(queries, jnp.float32)
    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]
    k_eff = min(k_max, n)
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def one_chunk(qc):
        d2 = _sq_dists(qc, points)
        d2 = jnp.where(d2 <= r2, d2, jnp.inf)
        neg, idx = jax.lax.top_k(-d2, k_eff)
        return idx.astype(jnp.int32), -neg

    chunk = _query_chunk_size(n)
    idx, d2 = _chunked_over_queries(one_chunk, queries, chunk)
    if k_eff < k_max:
        pad = ((0, 0), (0, k_max - k_eff))
        idx = jnp.pad(idx, pad)
        d2 = jnp.pad(d2, pad, constant_values=jnp.inf)
    mask = jnp.isfinite(d2)
    diff = queries[:, None, :] - points[jnp.where(mask, idx, 0)]
    dist_exact = jnp.linalg.norm(diff, axis=-1)
    # Recheck the radius on exact distances so borderline pairs are consistent.
    mask = mask & (dist_exact <= radius)
    dist = jnp.where(mask, dist_exact, jnp.inf)
    return Neighborhoods(jnp.where(mask, idx, 0), dist, mask)


@jax.jit
def radius_count(queries: jnp.ndarray, points: jnp.ndarray, radius) -> jnp.ndarray:
    """Number of points within ``radius`` of each query — used to validate
    ``k_max`` caps and for density-threshold keypoint selection."""
    queries = jnp.asarray(queries, jnp.float32)
    points = jnp.asarray(points, jnp.float32)
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def one_chunk(qc):
        return jnp.sum(_sq_dists(qc, points) <= r2, axis=-1).astype(jnp.int32)

    return _chunked_over_queries(one_chunk, queries, _query_chunk_size(points.shape[0]))


@jax.jit
def nearest_neighbor(queries: jnp.ndarray, points: jnp.ndarray):
    """1-NN (``KDTree.query(q)``): returns ``(dist, idx)`` of shape ``(Q,)``.

    The hot primitive of ICP and of the overlap metrics; argmin over a tiled
    distance matrix, no top_k needed.
    """
    queries = jnp.asarray(queries, jnp.float32)
    points = jnp.asarray(points, jnp.float32)

    def one_chunk(qc):
        d2 = _sq_dists(qc, points)
        idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        return idx, jnp.take_along_axis(d2, idx[:, None].astype(jnp.int32), axis=-1)[:, 0]

    idx, _ = _chunked_over_queries(one_chunk, queries, _query_chunk_size(points.shape[0]))
    dist = jnp.linalg.norm(queries - points[idx], axis=-1)
    return dist, idx
