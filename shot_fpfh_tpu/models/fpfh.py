"""FPFH (Fast Point Feature Histograms), batched formulation.

Algorithmic parity with the reference (descriptors/fpfh.py:16-117), which
implements Rusu et al. 2009:

- Pass 1 (SPFH): for every cloud point, the Darboux-frame angles
  ``α = v·n_j``, ``φ = (p_j−p_i)·u/‖p_j−p_i‖``, ``θ = atan2(n_j·w, n_j·u)``
  over its radius neighborhood (``u = n_i``, ``v = (p_j−p_i)×u`` — kept
  *unnormalized* exactly as the reference does, so out-of-range α values fall
  outside the histogram and are dropped, matching ``np.histogramdd`` range
  semantics), accumulated in either a joint ``n_bins³`` histogram or three
  decorrelated 1-D histograms, normalized by the neighborhood size (self
  included).
- Pass 2 (FPFH): ``FPFH(p) = SPFH(p) + (1/|N(p)|) Σ_j SPFH(p_j)/d_j``.

The reference loops in Python over all N points; here both passes are masked
batched tensor ops (one ``radius_search``, one batched-histogram scatter, one
chunked gather-reduce).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.descriptor_bins import darboux_angles
from ..ops.histogram import batched_histogram, bin_index, factored_histogram
from ..ops.grid_hash import radius_search_with_values_auto


def compute_spfh(
    cloud_points: jnp.ndarray,
    normals: jnp.ndarray,
    radius,
    n_bins: int,
    k_max: int = 128,
    decorrelated: bool = False,
):
    """SPFH for every cloud point.  Returns (spfh (N, D), neighborhoods).

    Neighbor search auto-dispatches to the grid-hash engine for large clouds
    (every cloud point is a query here, so this pass is O(N·N) under brute
    force but O(N·27·cap) through the grid)."""
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid
    from ..ops.neighbors import Neighborhoods

    cloud = jnp.asarray(cloud_points, jnp.float32)
    nrm = jnp.asarray(normals, jnp.float32)
    n = cloud.shape[0]
    if n < AUTO_GRID_MIN_POINTS:
        # fused search: neighbor [points | normals] come back gathered
        nbr, vals = radius_search_with_values_auto(cloud, cloud, nrm, radius, k_max)
        spfh = _spfh_from_values(
            cloud, nrm, vals[..., :3], vals[..., 3:6], nbr.dist, nbr.mask,
            radius, n_bins, decorrelated,
        )
        return spfh, nbr
    # Large clouds: every point is a query, so the gathered values plus the
    # Darboux intermediates would hold O(N * k_max * 9) floats at once
    # (OOM at 1M points).  Stream query chunks through one compiled step;
    # only the (N, k_max) neighborhoods and the (N, D) SPFH accumulate.
    grid = build_grid(cloud, float(radius) / 2, extras=nrm, halo=2)
    # chunk: bounded padding for clouds between the auto threshold and 128k
    chunk = min(1 << 17, -(-n // 1024) * 1024)

    spfh_parts, idx_parts, dist_parts, mask_parts = [], [], [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        pad = chunk - (e - s)
        q_pts = jnp.pad(cloud[s:e], ((0, pad), (0, 0)))
        q_nrm = jnp.pad(nrm[s:e], ((0, pad), (0, 0)))
        # module-level jitted step: one compile serves every chunk; results
        # stay on device until the concatenation below
        spfh_c, nbr_c = _spfh_chunk(grid, q_pts, q_nrm, radius, k_max,
                                    n_bins, decorrelated)
        spfh_parts.append(spfh_c[:e - s])
        idx_parts.append(nbr_c.idx[:e - s])
        dist_parts.append(nbr_c.dist[:e - s])
        mask_parts.append(nbr_c.mask[:e - s])
    spfh = jnp.concatenate(spfh_parts)
    nbr = Neighborhoods(
        jnp.concatenate(idx_parts),
        jnp.concatenate(dist_parts),
        jnp.concatenate(mask_parts),
    )
    return spfh, nbr


@functools.partial(jax.jit, static_argnames=("k_max", "n_bins", "decorrelated"))
def _spfh_chunk(grid, q_pts, q_nrm, radius, k_max, n_bins, decorrelated):
    """One streamed SPFH block: search + Darboux histogram (module-level so
    the compile caches across chunks and calls)."""
    from ..ops.grid_hash import grid_radius_search

    nbr_c, vals = grid_radius_search(grid, q_pts, radius, k_max,
                                     with_values=True)
    spfh_c = _spfh_from_values(
        q_pts, q_nrm, vals[..., :3], vals[..., 3:6], nbr_c.dist,
        nbr_c.mask, radius, n_bins, decorrelated,
    )
    return spfh_c, nbr_c


@functools.partial(jax.jit, static_argnames=("n_bins", "decorrelated"))
def _spfh_from_values(cloud, nrm, p_j, n_j, d, mask, radius, n_bins, decorrelated):
    diff = p_j - cloud[:, None, :]
    valid = mask & (d > 0)

    u = nrm[:, None, :]  # (N, 1, 3)
    v = jnp.cross(diff, jnp.broadcast_to(u, diff.shape))
    w = jnp.cross(jnp.broadcast_to(u, diff.shape), v)
    alpha = jnp.sum(v * n_j, axis=-1)
    phi = jnp.sum(diff * u, axis=-1) / jnp.where(valid, d, 1.0)
    theta = jnp.arctan2(jnp.sum(n_j * w, axis=-1), jnp.sum(n_j * u, axis=-1))

    a_bin, a_in = bin_index(alpha, -1.0, 1.0, n_bins)
    p_bin, p_in = bin_index(phi, -1.0, 1.0, n_bins)
    t_bin, t_in = bin_index(theta, -jnp.pi / 2, jnp.pi / 2, n_bins)

    count = jnp.maximum(jnp.sum(mask, axis=-1), 1).astype(jnp.float32)
    if decorrelated:
        parts = []
        for b, in_r in ((a_bin, a_in), (p_bin, p_in), (t_bin, t_in)):
            wgt = (valid & in_r).astype(jnp.float32)
            parts.append(batched_histogram(b, wgt, n_bins))
        # reference layout: np.vstack((h_alpha, h_phi, h_theta)).T ravel —
        # i.e. interleaved (bin0: α,φ,θ, bin1: α,φ,θ, ...)
        spfh = jnp.stack(parts, axis=-1).reshape(cloud.shape[0], 3 * n_bins)
    else:
        # n_bins³ joint histogram factored as α x (φ, θ): matmul contraction
        # instead of a scatter-add (see ops.histogram.factored_histogram)
        wgt = (valid & a_in & p_in & t_in).astype(jnp.float32)
        spfh = factored_histogram(
            a_bin, p_bin * n_bins + t_bin, wgt, n_bins, n_bins**2
        )
    return spfh / count[:, None]


# ---------------------------------------------------------------------------
# Grid-window formulation (large clouds): grouped feature-planar windows, no
# top-k — SPFH computed over the EXACT uncapped radius neighborhood in SORTED
# order so the aggregation pass re-gathers neighbor SPFH rows with the same
# grouped indices.  Mirrors the SHOT window path (models/shot.py).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_bins", "decorrelated", "chunk"))
def _spfh_window_sorted(grid, radius, n_bins: int, decorrelated: bool,
                        chunk: int = 8192):
    """SPFH for every cloud point, in grid-SORTED order.  Returns
    (N_pad, D)."""
    from ..ops.grid_hash import grouped_window_gather

    pts = grid.packed_sorted[:, :3]
    nrm = grid.packed_sorted[:, 3:6]
    n = pts.shape[0]
    n_chunks = -(-n // chunk)
    padded = n_chunks * chunk
    pts_p = jnp.pad(pts, ((0, padded - n), (0, 0)), constant_values=1.0e6)
    nrm_p = jnp.pad(nrm, ((0, padded - n), (0, 0)))

    def one(args):
        return _spfh_window_block(grid, args[0], args[1], radius, n_bins,
                                  decorrelated)

    out = jax.lax.map(one, (pts_p.reshape(n_chunks, chunk, 3),
                            nrm_p.reshape(n_chunks, chunk, 3)))
    return out.reshape(padded, -1)


def _spfh_window_block(grid, qc, qn, radius, n_bins, decorrelated):
    """One SPFH block over grouped feature-planar windows (shared by the
    single-device chunked pass and the sharded pass)."""
    from ..ops.grid_hash import window_distances

    vals, d, win_ok, _rows = window_distances(grid, qc)
    dist_inf = jnp.where(win_ok & (d <= radius), d, jnp.inf)
    return spfh_from_window(qc, qn, vals, dist_inf, n_bins, decorrelated)


def spfh_from_window(qc, qn, vals, dist_inf, n_bins: int, decorrelated: bool):
    """SPFH of each query from its dense FEATURE-FIRST candidate window:
    ``vals`` (Q, 8, W) ``[x y z nx ny nz 0 0]`` rows, ``dist_inf`` (Q, W)
    distance or +inf outside the radius.  The query itself (distance 0)
    counts in the neighborhood size but adds no angles, as in the
    reference."""
    ok = jnp.isfinite(dist_inf)
    d = jnp.where(ok, dist_inf, 0.0)
    valid = ok & (d > 0)
    # the Darboux frame needs the raw offsets, not just |d|; angle math lives
    # in ops.descriptor_bins.darboux_angles
    dx = vals[:, 0, :] - qc[:, 0:1]
    dy = vals[:, 1, :] - qc[:, 1:2]
    dz = vals[:, 2, :] - qc[:, 2:3]
    ux, uy, uz = qn[:, 0:1], qn[:, 1:2], qn[:, 2:3]
    nx, ny, nz = vals[:, 3, :], vals[:, 4, :], vals[:, 5, :]
    alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz,
                                       jnp.where(valid, d, 1.0))

    a_bin, a_in = bin_index(alpha, -1.0, 1.0, n_bins)
    p_bin, p_in = bin_index(phi, -1.0, 1.0, n_bins)
    t_bin, t_in = bin_index(theta, -jnp.pi / 2, jnp.pi / 2, n_bins)
    count = jnp.maximum(jnp.sum(ok, axis=-1), 1).astype(jnp.float32)
    if decorrelated:
        parts = []
        for b, in_r in ((a_bin, a_in), (p_bin, p_in), (t_bin, t_in)):
            wgt = (valid & in_r).astype(jnp.float32)
            parts.append(batched_histogram(b, wgt, n_bins))
        spfh_c = jnp.stack(parts, axis=-1).reshape(qc.shape[0], 3 * n_bins)
    else:
        wgt = (valid & a_in & p_in & t_in).astype(jnp.float32)
        spfh_c = factored_histogram(
            a_bin, p_bin * n_bins + t_bin, wgt, n_bins, n_bins**2
        )
    return spfh_c / count[:, None]


@functools.partial(jax.jit, static_argnames=("group", "kp_chunk"))
def _fpfh_window_aggregate(grid, spfh_sorted, kp_sorted_idx, radius,
                           group: int = 8, kp_chunk: int = 4096):
    """FPFH(p) = SPFH(p) + (Σ_{j,d>0} SPFH(j)/d_j) / |N(p)| with neighbor
    SPFH rows fetched by the SAME grouped window indices as the search."""
    n, d_dim = spfh_sorted.shape[0], spfh_sorted.shape[1]
    ng = -(-n // group)
    spfh_g = jnp.pad(
        spfh_sorted, ((0, ng * group - n), (0, 0))
    ).reshape(ng, group * d_dim)

    n_kp = kp_sorted_idx.shape[0]
    n_chunks = -(-n_kp // kp_chunk)
    padded = n_chunks * kp_chunk
    kp_p = jnp.pad(kp_sorted_idx, (0, padded - n_kp)).reshape(n_chunks, kp_chunk)

    def one(kp_c):
        return _fpfh_window_agg_block(grid, spfh_sorted, spfh_g, kp_c,
                                      radius, group)

    out = jax.lax.map(one, kp_p)
    return out.reshape(padded, -1)[:n_kp]


def _fpfh_window_agg_block(grid, spfh_sorted, spfh_g, kp_c, radius, group):
    """One FPFH-aggregation block: neighbor SPFH rows fetched with the same
    grouped window indices as the search (shared by single-device/sharded)."""
    from ..ops.grid_hash import window_distances

    d_dim = spfh_sorted.shape[1]
    qc = grid.packed_sorted[kp_c, :3]
    vals, d, win_ok, rows = window_distances(grid, qc, group=group)
    ok = win_ok & (d <= radius)
    m = ok & (d > 0)
    wt = jnp.where(m, 1.0 / jnp.where(m, d, 1.0), 0.0)   # (C, W)
    gc = rows.shape[1] // group
    grp_idx = rows[:, ::group] // group                  # (C, GC)
    nb_spfh = spfh_g[grp_idx]                            # (C, GC, G*D)
    nb_spfh = nb_spfh.reshape(qc.shape[0], gc, group, d_dim)
    acc = jnp.einsum("cgid,cgi->cd", nb_spfh,
                     wt.reshape(qc.shape[0], gc, group))
    count = jnp.maximum(jnp.sum(ok, axis=-1), 1).astype(jnp.float32)
    return spfh_sorted[kp_c] + acc / count[:, None]


@functools.partial(jax.jit, static_argnames=("kp_chunk",))
def _fpfh_aggregate(spfh, nbr_idx, nbr_dist, nbr_mask, keypoint_indices, kp_chunk: int = 256):
    """FPFH(p) = SPFH(p) + (Σ_{j, d>0} SPFH(j)/d_j) / |N(p)| over keypoints."""
    n_kp = keypoint_indices.shape[0]
    n_chunks = -(-n_kp // kp_chunk)
    pad = n_chunks * kp_chunk - n_kp
    kp = jnp.pad(keypoint_indices, (0, pad)).reshape(n_chunks, kp_chunk)

    def one_chunk(kp_c):
        idx = nbr_idx[kp_c]  # (C, K)
        d = nbr_dist[kp_c]
        m = nbr_mask[kp_c] & (d > 0)
        weights = jnp.where(m, 1.0 / jnp.where(m, d, 1.0), 0.0)
        acc = jnp.einsum("ckd,ck->cd", spfh[idx], weights)
        count = jnp.maximum(jnp.sum(nbr_mask[kp_c], axis=-1), 1).astype(jnp.float32)
        return spfh[kp_c] + acc / count[:, None]

    out = jax.lax.map(one_chunk, kp)
    return out.reshape(n_chunks * kp_chunk, -1)[:n_kp]


def compute_fpfh_descriptor(
    keypoint_indices,
    cloud_points,
    normals,
    radius,
    n_bins: int = 5,
    decorrelated: bool = False,
    k_max: int = 128,
    mesh=None,
):
    """Full FPFH pipeline (reference ``compute_fpfh_descriptor``,
    descriptors/fpfh.py:16-117).  Returns (n_keypoints, n_bins³) descriptors
    (or (n_keypoints, 3·n_bins) when decorrelated).

    With a multi-device ``mesh`` both passes shard over it
    (``parallel.sharded.sharded_fpfh``): the SPFH query axis is data-parallel
    and the keypoint aggregation re-gathers the replicated SPFH table."""
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.sharded import sharded_fpfh

        return sharded_fpfh(
            keypoint_indices, cloud_points, normals, radius, mesh,
            n_bins=n_bins, k_max=k_max, decorrelated=decorrelated,
        )
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    n_cloud = np.shape(cloud_points)[0]
    if n_cloud >= AUTO_GRID_MIN_POINTS:
        # grid-window formulation: exact uncapped neighborhoods, no top-k;
        # SPFH computed in sorted order so aggregation reuses the grouped
        # window indices for neighbor-SPFH fetches
        # host-side conversion straight from the caller's arrays (usually
        # already numpy) so build_grid's content cache can engage
        grid = build_grid(np.asarray(cloud_points, np.float32),
                          float(radius) / 2,
                          extras=np.asarray(normals, np.float32), halo=2)
        spfh_sorted = _spfh_window_sorted(grid, radius, n_bins, decorrelated)
        inv_perm = jnp.zeros(n_cloud, jnp.int32).at[grid.orig_idx].set(
            jnp.arange(n_cloud, dtype=jnp.int32)
        )
        kp_sorted = inv_perm[jnp.asarray(keypoint_indices, jnp.int32)]
        return _fpfh_window_aggregate(grid, spfh_sorted, kp_sorted, radius)
    spfh, nbr = compute_spfh(cloud_points, normals, radius, n_bins, k_max, decorrelated)
    kp = jnp.asarray(keypoint_indices, jnp.int32)
    return _fpfh_aggregate(spfh, nbr.idx, nbr.dist, nbr.mask, kp)
