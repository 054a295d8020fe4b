"""Descriptor matching: tiled distance matrices + filters.

Replaces the reference's ``scipy.cdist``-based matching
(matching/matching.py:9-221).  Distances are computed as a tiled matmul
(``‖a−b‖² = ‖a‖²+‖b‖²−2a·b``) with per-row argmin / top-2 — the full
``K_scan × K_ref`` matrix is only materialized per scan-chunk, so memory stays
bounded for large keypoint sets (and the same row-chunk structure rides the
ring-matching collective in ``parallel.sharded``).

The "empty descriptor" convention: all-zero rows (SHOT neighborhoods that were
too sparse) are excluded from matching, as in the reference
(matching.py:43-44).

Documented deviation: the reference's ``double_matching_with_rejects`` is
inverted/broken (keeps ratios ≥ threshold and crashes indexing with float
distances — SURVEY.md §2.4.1); ``lowe_matching`` here implements the correct
ratio test (keep ``d1/d2 <= threshold``).
"""

from __future__ import annotations

import functools
import logging
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

_CHUNK = 1024
# ref-axis tile for the scanned top-1/top-2 reductions: the (CHUNK, REF_TILE)
# distance tile (16 MB f32) is reduced into the per-row carry while still hot,
# instead of materializing + re-reading the full (CHUNK, K_ref) strip
_REF_TILE = 4096


def _pad_rows(x: jnp.ndarray, chunk: int):
    n = x.shape[0]
    n_chunks = -(-n // chunk)
    return jnp.pad(x, ((0, n_chunks * chunk - n), (0, 0))), n_chunks


@jax.jit
def descriptor_sq_dists(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dense squared-distance matrix (use only when it fits)."""
    an = jnp.sum(a * a, axis=-1, keepdims=True)
    bn = jnp.sum(b * b, axis=-1)[None, :]
    return jnp.maximum(an + bn - 2.0 * (a @ b.T), 0.0)


def top2_rows(d2: jnp.ndarray):
    """Row-wise nearest + second-nearest of a masked (inf = invalid) squared-
    distance matrix: returns ``(i1, d1_sq, d2_sq)``.

    Two argmin passes on purpose: ``lax.top_k(k=2)`` over an N-wide row is
    sort-like, while argmin + a masked second min-reduction are plain
    elementwise reductions that fuse with the distance tile.  Shared by the
    chunked matcher, the fused program, and the ring matcher."""
    i1 = jnp.argmin(d2, axis=-1).astype(jnp.int32)
    d1_sq = jnp.take_along_axis(d2, i1[:, None], axis=-1)[:, 0]
    cols = jnp.arange(d2.shape[1], dtype=jnp.int32)[None, :]
    d2_sq = jnp.min(jnp.where(cols == i1[:, None], jnp.inf, d2), axis=-1)
    return i1, d1_sq, d2_sq


def top2_merge(carry, tile):
    """Merge a tile's per-row ``(i1, d1_sq, d2_sq)`` (global indices) into a
    running carry.  Strict ``<`` keeps the earlier tile on ties, so scanning
    tiles in index order reproduces dense argmin-first semantics exactly.
    The merged second-nearest is the second element of the sorted 4-way merge:
    ``min(max(c1, t1), c2, t2)``."""
    ci, cd1, cd2 = carry
    ti, td1, td2 = tile
    better = td1 < cd1
    return (
        jnp.where(better, ti, ci),
        jnp.where(better, td1, cd1),
        jnp.minimum(jnp.maximum(cd1, td1), jnp.minimum(cd2, td2)),
    )


@functools.partial(jax.jit, static_argnames=("use_bf16", "want_top2"))
def _top_scan(a, b, b_valid, use_bf16: bool, want_top2: bool):
    """Chunked scan-row x scanned ref-tile nearest / top-2 reduction.

    The matcher runs it with ``use_bf16=True``: bf16 operands with f32
    accumulation (tensor-core rate; descriptors are histogram weights, so the
    ~0.4% operand rounding is far below the matching noise floor — DESIGN
    §3).  ``use_bf16=False`` is the f32 reference the bf16 paths are checked
    against.

    The (CHUNK, REF_TILE) distance tile is produced by one dot and reduced
    into the
    per-row running ``(i1, d1_sq[, d2_sq])`` carry, so the full
    ``(CHUNK, K_ref)`` strip is never materialized.  The tile itself still
    round-trips device memory between the dot and the reduction; the Triton
    kernel (``ops.match_triton``) keeps it in registers.

    Norms are computed in f32 FROM the compute-dtype values, so self-distances
    cancel exactly and bf16 only perturbs the descriptors themselves (≤0.4%
    relative), not the distance algebra."""
    n, dim = a.shape
    nb = b.shape[0]
    cdt = jnp.bfloat16 if use_bf16 else jnp.float32
    ac = a.astype(cdt)
    bc = b.astype(cdt)
    an = jnp.sum(ac.astype(jnp.float32) ** 2, axis=-1)
    bn = jnp.sum(bc.astype(jnp.float32) ** 2, axis=-1)

    ap, n_chunks = _pad_rows(ac, _CHUNK)
    anp = jnp.pad(an, (0, ap.shape[0] - n))
    n_tiles = -(-nb // _REF_TILE)
    pad_b = n_tiles * _REF_TILE - nb
    b_tiles = jnp.pad(bc, ((0, pad_b), (0, 0))).reshape(n_tiles, _REF_TILE, dim)
    bn_tiles = jnp.pad(bn, (0, pad_b)).reshape(n_tiles, _REF_TILE)
    bv_tiles = jnp.pad(b_valid, (0, pad_b), constant_values=False).reshape(
        n_tiles, _REF_TILE)
    bases = _REF_TILE * jnp.arange(n_tiles, dtype=jnp.int32)

    def one_chunk(xs):
        a_c, an_c = xs

        def step(carry, tile):
            b_t, bn_t, bv_t, base = tile
            prod = jax.lax.dot_general(
                a_c, b_t, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
            d2t = jnp.maximum(an_c[:, None] + bn_t[None, :] - 2.0 * prod, 0.0)
            d2t = jnp.where(bv_t[None, :], d2t, jnp.inf)
            if want_top2:
                i1t, d1t, d2t2 = top2_rows(d2t)
                return top2_merge(carry, (base + i1t, d1t, d2t2)), None
            i1t = jnp.argmin(d2t, axis=-1).astype(jnp.int32)
            d1t = jnp.take_along_axis(d2t, i1t[:, None], axis=-1)[:, 0]
            ci, cd1 = carry
            better = d1t < cd1
            return (jnp.where(better, base + i1t, ci),
                    jnp.where(better, d1t, cd1)), None

        shape = (a_c.shape[0],)
        init = (jnp.zeros(shape, jnp.int32), jnp.full(shape, jnp.inf))
        if want_top2:
            init = init + (jnp.full(shape, jnp.inf),)
        carry, _ = jax.lax.scan(step, init, (b_tiles, bn_tiles, bv_tiles, bases))
        return carry

    res = jax.lax.map(one_chunk, (ap.reshape(n_chunks, _CHUNK, dim),
                                  anp.reshape(n_chunks, _CHUNK)))
    return tuple(r.reshape(-1)[:n] for r in res)


def _use_kernel() -> bool:
    """On a GPU the matcher runs the Pallas Triton kernel
    (``ops.match_triton``); every other backend runs the XLA tile scan.
    Both take bf16 operands with f32 accumulation."""
    return jax.default_backend() == "gpu"


def nearest_descriptor(a: jnp.ndarray, b: jnp.ndarray, b_valid: jnp.ndarray):
    """Per-row nearest neighbor of ``a`` in ``b``: returns (idx, dist)."""
    if _use_kernel():
        from ..ops.match_triton import top2_triton

        idx, d1_sq, _ = top2_triton(a, b, b_valid)
    else:
        idx, d1_sq = _top_scan(a, b, b_valid, True, False)
    return idx, jnp.sqrt(d1_sq)


def top2_descriptor(a: jnp.ndarray, b: jnp.ndarray, b_valid: jnp.ndarray):
    """Nearest and second-nearest: returns (idx1, d1, d2) — the Lowe-ratio
    ingredients."""
    if _use_kernel():
        from ..ops.match_triton import top2_triton

        idx, d1_sq, d2_sq = top2_triton(a, b, b_valid)
    else:
        idx, d1_sq, d2_sq = _top_scan(a, b, b_valid, True, True)
    return idx, jnp.sqrt(d1_sq), jnp.sqrt(d2_sq)


# ----------------------------------------------------- multiscale kernels ---
# Sentinel for invalid entries of the multiscale distance matrix (the
# reference's ``max_val = 1000.0``, matching/matching.py:96); matches whose
# combined distance reaches it are dropped.
MS_MAX_VAL = 1000.0


def _ms_chunk_dists(a_chunk, b, a_ok_chunk, b_ok):
    """(chunk, R) sentinel-masked distances for one scale — the only dense
    tile the multiscale matcher ever materializes."""
    d2 = descriptor_sq_dists(a_chunk, b)
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    return jnp.where(a_ok_chunk[:, None] & b_ok[None, :], d, MS_MAX_VAL)


def _ms_scale_pass(a, b, a_ok, b_ok, row_base: int = 0, vary=None):
    """One scale's row argmin and running column argmin, chunked over scan
    rows.  Returns ``(row_argmin (Q,), col_min (R,), col_argmin (R,))`` —
    column indices of the argmins are global scan-row ids (``row_base`` +
    local), so sharded callers can combine shards exactly.  Ties resolve to
    the first (lowest) row/column index, matching ``np.argmin``.

    ``vary``: shard_map callers pass a pcast-to-varying so the scan carry
    init (built from constants, hence replicated) typechecks against the
    shard-dependent carry updates."""
    if vary is None:
        vary = lambda x: x  # noqa: E731
    n = a.shape[0]
    ap, n_chunks = _pad_rows(a, _CHUNK)
    okp = jnp.pad(a_ok, (0, ap.shape[0] - n), constant_values=False)
    n_ref = b.shape[0]

    def step(carry, xs):
        col_d, col_i = carry
        a_c, ok_c, base = xs
        d = _ms_chunk_dists(a_c, b, ok_c, b_ok)
        d_local = jnp.min(d, axis=0)
        i_local = jnp.argmin(d, axis=0).astype(jnp.int32)
        better = d_local < col_d  # strict: earlier chunk wins ties
        col_d = jnp.where(better, d_local, col_d)
        col_i = jnp.where(better, base + i_local, col_i)
        return (col_d, col_i), jnp.argmin(d, axis=1).astype(jnp.int32)

    bases = row_base + _CHUNK * jnp.arange(n_chunks, dtype=jnp.int32)
    (col_d, col_i), row_i = jax.lax.scan(
        step,
        (vary(jnp.full((n_ref,), jnp.inf, jnp.float32)),
         vary(jnp.zeros((n_ref,), jnp.int32))),
        (ap.reshape(n_chunks, _CHUNK, -1), okp.reshape(n_chunks, _CHUNK), bases),
    )
    return row_i.reshape(-1)[:n], col_d, col_i


def _ms_combined_top1(a_ms, b_ms, row_ok_ms, b_ok_ms, vary=None):
    """Row argmin + distance of ``min_s D_s`` without materializing any
    K x K matrix: scan-row chunks x a lax.scan over scales carrying the
    running elementwise minimum."""
    if vary is None:
        vary = lambda x: x  # noqa: E731
    n = a_ms.shape[1]
    n_ref = b_ms.shape[1]
    n_chunks = -(-n // _CHUNK)
    pad = n_chunks * _CHUNK - n
    ap = jnp.pad(a_ms, ((0, 0), (0, pad), (0, 0)))
    okp = jnp.pad(row_ok_ms, ((0, 0), (0, pad)), constant_values=False)

    def one_chunk(xs):
        a_sc, ok_sc = xs  # (S, C, D), (S, C)

        def scale_step(run_min, scale_xs):
            a_s, ok_s, b_s, bok_s = scale_xs
            return jnp.minimum(run_min, _ms_chunk_dists(a_s, b_s, ok_s, bok_s)), None

        run0 = vary(jnp.full((a_sc.shape[1], n_ref), MS_MAX_VAL, jnp.float32))
        run, _ = jax.lax.scan(scale_step, run0, (a_sc, ok_sc, b_ms, b_ok_ms))
        idx = jnp.argmin(run, axis=1).astype(jnp.int32)
        return idx, jnp.take_along_axis(run, idx[:, None], axis=1)[:, 0]

    idx, dist = jax.lax.map(
        one_chunk,
        (ap.reshape(a_ms.shape[0], n_chunks, _CHUNK, -1).transpose(1, 0, 2, 3),
         okp.reshape(a_ms.shape[0], n_chunks, _CHUNK).transpose(1, 0, 2)),
    )
    return idx.reshape(-1)[:n], dist.reshape(-1)[:n]


@functools.partial(jax.jit, static_argnames=("filter_nonreciprocal",))
def multiscale_top1(scan_ms, ref_ms, *, filter_nonreciprocal: bool = False):
    """Single-device multiscale matcher: per scan point, the nearest ref
    point under the running-min-over-scales distance with optional per-scale
    reciprocal rejection (whole non-reciprocal rows masked to the sentinel).

    DELIBERATE DEVIATION (ADVICE r3 #1): the reference's masking line
    ``distance_matrix_scale[non_empty][non_recip] = max_val``
    (``matching.py:100-104``) chains fancy indexing, so it writes into a
    temporary copy and is a silent no-op — reference multiscale matching
    never actually drops non-reciprocal matches.  We implement the evident
    intent (the mask is applied); pass ``filter_nonreciprocal=False`` for
    bit-parity with the reference's de-facto behavior.  See PARITY.md.

    Returns ``(idx (Q,), dist (Q,))``; rows whose distance reaches
    ``MS_MAX_VAL`` carry no valid match."""
    s_ok = jnp.any(scan_ms != 0, axis=2)  # (S, Q)
    r_ok = jnp.any(ref_ms != 0, axis=2)   # (S, R)
    row_ok = s_ok
    if filter_nonreciprocal:
        def recip_scale(xs):
            a, a_ok, b, b_ok = xs
            row_i, _, col_i = _ms_scale_pass(a, b, a_ok, b_ok)
            return col_i[row_i] == jnp.arange(a.shape[0], dtype=jnp.int32)

        recip = jax.lax.map(recip_scale, (scan_ms, s_ok, ref_ms, r_ok))
        row_ok = s_ok & recip
    return _ms_combined_top1(scan_ms, ref_ms, row_ok, r_ok)


def _nonzero_rows(desc: np.ndarray) -> np.ndarray:
    return np.nonzero(np.any(np.asarray(desc), axis=1))[0]


def _split_nonzero(desc):
    """(nonzero-row indices on host, nonzero rows ON DEVICE).

    Device-array inputs stay resident: the validity mask is reduced on device
    and only the (K,) boolean crosses to the host — at 100k x 352 descriptors
    the full matrix would be a ~140 MB device→host→device round trip."""
    if isinstance(desc, jax.Array):
        mask = np.asarray(jnp.any(desc != 0, axis=1))
        nz = np.nonzero(mask)[0]
        return nz, jnp.asarray(desc, jnp.float32)[jnp.asarray(nz)]
    arr = np.asarray(desc)
    nz = np.nonzero(np.any(arr, axis=1))[0]
    return nz, jnp.asarray(arr[nz], jnp.float32)


def _use_mesh(mesh) -> bool:
    return mesh is not None and mesh.devices.size > 1


def basic_matching(scan_descriptors, ref_descriptors, mesh=None):
    """Each non-empty scan descriptor matched to its nearest non-empty ref
    descriptor (reference ``basic_matching``, matching/matching.py:149-169).

    Returns (scan_indices, ref_indices) as NumPy int arrays.  Device-array
    descriptors stay on device through the distance computation; only the
    small index/distance vectors come back to the host."""
    scan_nz, a = _split_nonzero(scan_descriptors)
    ref_nz, b = _split_nonzero(ref_descriptors)
    if _use_mesh(mesh):
        from ..parallel.sharded import ring_match

        idx = ring_match(np.asarray(a), np.asarray(b), mesh).idx
    else:
        idx, _ = nearest_descriptor(a, b, jnp.ones(b.shape[0], bool))
    return scan_nz, ref_nz[np.asarray(idx)]


@functools.partial(jax.jit, static_argnames=())
def _lowe_keep(d1, d2, threshold):
    """Ratio-test mask ON DEVICE (d2 == 0 -> ratio := 1, i.e. rejected at any
    threshold < 1): only a (K,) bool crosses to the host instead of two f32
    distance vectors."""
    ratio = jnp.where(d2 > 0, d1 / jnp.where(d2 > 0, d2, 1.0), 1.0)
    return ratio <= threshold


def lowe_matching(scan_descriptors, ref_descriptors, threshold: float = 0.8,
                  verbose=True, mesh=None):
    """Ratio-test matching: keep matches whose nearest/second-nearest distance
    ratio is ≤ ``threshold`` (corrected version of the reference's broken
    ``double_matching_with_rejects``, matching/matching.py:172-221)."""
    scan_nz, a = _split_nonzero(scan_descriptors)
    ref_nz, b = _split_nonzero(ref_descriptors)
    if _use_mesh(mesh):
        from ..parallel.sharded import ring_match

        res = ring_match(np.asarray(a), np.asarray(b), mesh)
        idx, d1, d2 = res.idx, res.d1, res.d2
        ratio = np.divide(d1, d2, out=np.ones_like(d1), where=d2 > 0)
        mask = ratio <= threshold
    else:
        idx_j, d1_j, d2_j = top2_descriptor(a, b, jnp.ones(len(b), bool))
        mask = np.asarray(_lowe_keep(d1_j, d2_j, jnp.float32(threshold)))
        idx = np.asarray(idx_j)
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", mask.sum(), len(scan_nz))
    return scan_nz[mask], ref_nz[idx[mask]]


# ------------------------------------------------------------- filters ------
FilterFunction = Callable[..., np.ndarray]


def threshold_filter(distances: np.ndarray, threshold_multiplier: float) -> np.ndarray:
    """Keep matches within ``multiplier x`` the smallest nonzero distance
    (reference matching/filters.py:19-23)."""
    nonzero = distances[np.nonzero(distances)[0]]
    floor = nonzero.min() if len(nonzero) else 0.0
    return distances <= floor * threshold_multiplier


def quantile_filter(distances: np.ndarray, quantiles: tuple[float, float]) -> np.ndarray:
    lo, hi = np.quantile(distances, quantiles)
    return (distances >= lo) & (distances <= hi)


def left_median_filter(distances: np.ndarray) -> np.ndarray:
    """Keep matches in the band between halfway-to-the-median and the median.

    Documented deviation: the reference computes the lower edge from
    ``distances.nonzero()[0].min()`` — the minimum *index* of a nonzero
    distance, not the minimum nonzero distance
    (reference matching/filters.py:34-40).  This implements the evident
    intent: the band floor is halfway between the smallest nonzero distance
    and the median (same "smallest nonzero" convention ``threshold_filter``
    already uses)."""
    med = np.median(distances)
    nonzero = distances[np.nonzero(distances)[0]]
    floor = nonzero.min() if len(nonzero) else 0.0
    return (distances <= med) & (distances >= (med + floor) / 2)


def match_descriptors(
    scan_descriptors,
    ref_descriptors,
    filter_callback: FilterFunction | None = None,
    filter_nonreciprocal: bool = False,
    verbose: bool = True,
    n_min_matches: int = 100,
    mesh=None,
    **kwargs,
):
    """Generic matcher with pluggable distance filters, optional reciprocal
    filtering with a fallback below ``n_min_matches``, and a multiscale
    branch taking ``(n_scales, K, D)`` stacks combined by running elementwise
    minimum (reference ``match_descriptors``, matching/matching.py:9-146)."""
    if np.ndim(scan_descriptors) == 2:
        scan_nz, a = _split_nonzero(scan_descriptors)
        ref_nz, b = _split_nonzero(ref_descriptors)
        if _use_mesh(mesh):
            from ..parallel.sharded import ring_match

            res = ring_match(np.asarray(a), np.asarray(b), mesh)
            idx, dist = res.idx, res.d1
        else:
            idx, dist = nearest_descriptor(a, b, jnp.ones(b.shape[0], bool))
            idx, dist = np.asarray(idx), np.asarray(dist)
        keep = (
            filter_callback(dist, **kwargs)
            if filter_callback is not None
            else np.ones(len(dist), bool)
        )
        if filter_nonreciprocal:
            if _use_mesh(mesh):
                from ..parallel.sharded import ring_match

                back_idx = ring_match(np.asarray(b), np.asarray(a), mesh).idx
            else:
                back_idx, _ = nearest_descriptor(b, a, jnp.ones(len(a), bool))
            reciprocal = np.asarray(back_idx)[idx] == np.arange(len(idx))
            if (keep & reciprocal).sum() >= n_min_matches:
                keep = keep & reciprocal
            elif verbose:
                logger.warning("Too few reciprocal matches, keeping non-reciprocal matches.")
        if verbose:
            logger.info("Kept %d matches out of %d descriptors.", keep.sum(), len(scan_nz))
        return scan_nz[keep], ref_nz[idx[keep]]

    # multiscale: min over per-scale distance matrices ("infinite-norm
    # proximity", reference matching/matching.py:77-136) — device-resident and
    # chunked: the K_scan x K_ref matrix only ever exists one scan-chunk at a
    # time (running min across scales carried through a lax.scan), and on a
    # multi-device mesh the scan rows shard with the reciprocal column
    # reduction riding an all_gather.
    scan_ms = jnp.asarray(np.asarray(scan_descriptors), jnp.float32)
    ref_ms = jnp.asarray(np.asarray(ref_descriptors), jnp.float32)
    n_points = scan_ms.shape[1]
    if _use_mesh(mesh):
        from ..parallel.sharded import sharded_multiscale_match

        idx_j, dist_j = sharded_multiscale_match(
            np.asarray(scan_ms), np.asarray(ref_ms), mesh,
            filter_nonreciprocal=filter_nonreciprocal,
        )
    else:
        idx_j, dist_j = multiscale_top1(
            scan_ms, ref_ms, filter_nonreciprocal=filter_nonreciprocal
        )
    indices = np.asarray(idx_j)
    distances = np.asarray(dist_j)
    keep = (
        filter_callback(distances, **kwargs)
        if filter_callback is not None
        else np.ones(n_points, bool)
    ) & (distances < MS_MAX_VAL)
    if keep.sum() < n_min_matches and filter_nonreciprocal:
        logger.warning("Too few reciprocal matches, keeping non-reciprocal matches.")
        return match_descriptors(
            scan_descriptors, ref_descriptors, filter_callback,
            filter_nonreciprocal=False, verbose=verbose, mesh=mesh, **kwargs,
        )
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", keep.sum(), n_points)
    return np.nonzero(keep)[0], indices[keep]


# kept under the reference's name so configs/call sites translate 1:1
double_matching_with_rejects = lowe_matching
