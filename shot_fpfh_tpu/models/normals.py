"""PCA-based normals and geometric features, batched over query points.

Batched rewrite of the reference's per-point loops
(descriptors/pca_based_descriptors.py:15-244): one ``radius_search``/``knn``
call produces fixed-shape masked neighborhoods, and a single batched 3x3
eigendecomposition (``ops.eigh3``) replaces N calls to ``np.linalg.eigh``.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.eigh3 import eigh3x3, pca_eigh
from ..ops.grid_hash import (
    AUTO_GRID_MIN_POINTS,
    build_grid,
    grid_radius_pca,
    knn_auto,
)
from ..ops.neighbors import radius_search

logger = logging.getLogger(__name__)


def _grid_pts(original, device_arr):
    """Grid-build input: the host array (content-cacheable) when the caller
    passed one, otherwise the device array unchanged — never a forced d2h
    download (ADVICE r4)."""
    return (np.ascontiguousarray(original, np.float32)
            if isinstance(original, np.ndarray) else device_arr)


def _normals_knn(query_points, cloud_points, k, pre_computed_normals):
    nbr = knn_auto(query_points, cloud_points, k)
    return _normals_from_neighborhoods(query_points, cloud_points, nbr, pre_computed_normals)


def _knn_target_radii(grid, queries, k, sample, sample_kth):
    """Per-query adaptive radius targeting ~1.2k in-radius neighbors.

    Calibrates the local relation between a query's candidate-window count
    (9 cell_starts lookups — no point data touched) and its k-th-neighbor
    distance on a sampled subset: ``r_k ≈ A · wcnt^(−e)`` with the geometry
    exponent ``e`` fit in log space (≈1/2 on surface clouds where count ∝
    r², ≈1/3 volumetric) and a residual-quantile safety margin.  Entirely
    traceable (jnp throughout) so the whole calibration rides inside the
    fused one-dispatch program (`_streaming_knn_fused`); returns radii
    clipped to the grid's coverage contract (≤ cell_size)."""
    from ..ops.grid_hash import _zcolumn_runs

    r_hat = float(grid.cell_size_static)
    s, e_ = _zcolumn_runs(grid, jnp.asarray(sample, jnp.float32))
    wcnt_s = jnp.maximum(jnp.sum(e_ - s, axis=1).astype(jnp.float32), 1.0)
    x = jnp.log(wcnt_s)
    y = jnp.log(jnp.maximum(jnp.asarray(sample_kth, jnp.float32), 1e-9))
    var = jnp.var(x)
    cov_xy = jnp.mean((x - jnp.mean(x)) * (y - jnp.mean(y)))
    e_fit = jnp.where(var > 1e-12, -cov_xy / jnp.maximum(var, 1e-12), 0.5)
    e_fit = jnp.clip(e_fit, 1.0 / 3.0, 0.6)
    log_a = jnp.median(y + e_fit * x)
    resid = y - (log_a - e_fit * x)
    # q98 residual + 15%: the streaming pass visits the full candidate
    # window regardless of the per-query radius mask, so a generous margin
    # is FREE — it only widens the accepted superset — while every query it
    # covers skips the miss-net re-solve (on the 1M bench terrain q90 x 1.1
    # left 1.2% of queries to the net; q98 x 1.15 leaves 0.01%)
    margin = jnp.exp(jnp.quantile(resid, 0.98)) * 1.15
    qs, qe = _zcolumn_runs(grid, queries)
    wcnt = jnp.maximum(jnp.sum(qe - qs, axis=1).astype(jnp.float32), 1.0)
    r_q = jnp.exp(log_a) * margin * wcnt ** (-e_fit)
    return jnp.clip(r_q, r_hat / 8.0, r_hat)


_NET_BUCKET = 2048  # static miss-net size: covers 0.2% of 1M queries (q98
#                     margin leaves ~0.01% measured); larger miss sets fall
#                     back to the host-side exact path


@functools.partial(jax.jit, static_argnames=("k", "bucket"))
def _streaming_knn_fused(grid, q, c, sample, kth, pre, k, bucket):
    """The entire streaming k-NN normals computation in ONE device program:
    calibration fit + per-query radii + streaming covariance + miss-net
    (static-``bucket`` exact ``knn`` re-solve scattered with mode='drop')
    + eigenvectors, so the stage costs one dispatch.

    Returns ``(normals, n_miss)`` — callers must check ``n_miss <= bucket``
    and re-solve the (rare) overflow on the host."""
    from ..ops.neighbors import knn

    n = c.shape[0]
    r_q = _knn_target_radii(grid, q, k, sample, kth)
    cov, _, cnt = grid_radius_pca(grid, q, r_q)
    normals = _normals_from_cov(cov, pre)
    missing = cnt < min(k, n)
    n_miss = jnp.sum(missing)
    # fill_value=n: out-of-range rows gather clipped junk and are DROPPED on
    # the scatter below, so pad lanes never touch a real normal
    (mi,) = jnp.nonzero(missing, size=bucket, fill_value=n)
    fix = knn(q[mi], c, k)
    pre_m = None if pre is None else pre[jnp.minimum(mi, n - 1)]
    fixed = _normals_from_neighborhoods(q[jnp.minimum(mi, n - 1)], c, fix,
                                        pre_m)
    normals = normals.at[mi].set(fixed, mode="drop")
    return normals, n_miss, cnt


def _streaming_knn_normals(q, c, k, pre, sample_size: int = 512,
                           c_host=None):
    """k-mode normals for large clouds via ONE streaming covariance pass.

    DOCUMENTED DEVIATION from exact k-NN PCA (reference
    pca_based_descriptors.py:29-59, VERDICT r3 #3): the neighborhood is all
    points within a per-query adaptive radius targeting ≈1.2·k neighbors — a
    superset of the k nearest whenever the radius covers them — instead of
    exactly the k nearest.  PCA normals only stabilize with more in-plane
    samples, and this removes the top-k selection over every query's
    candidate window.  Queries whose radius under-covered (count < k) are
    re-solved with an exact k-NN pass, so no normal is ever estimated from
    fewer than min(k, N) points.  See PARITY.md (round 4)."""
    from ..ops.grid_hash import kth_distance_bound, quantized_kth_radius

    n = c.shape[0]
    stride = max(1, n // sample_size)
    sample = c[::stride][:sample_size]
    kth = kth_distance_bound(sample, c, k)
    r_hat = quantized_kth_radius(np.asarray(kth))  # host: static cell size
    c_np = c_host if isinstance(c_host, np.ndarray) else np.asarray(c)
    grid = build_grid(np.ascontiguousarray(c_np, np.float32), r_hat)
    normals, n_miss, cnt = _streaming_knn_fused(
        grid, q, jnp.asarray(c), jnp.asarray(sample), kth, pre,
        k=k, bucket=min(_NET_BUCKET, n),
    )
    if int(n_miss) > min(_NET_BUCKET, n):
        # rare overflow (density calibration off for this cloud): exact
        # grid-accelerated k-NN over the full miss set on the host path
        missing = np.asarray(cnt) < min(k, n)
        logger.warning(
            "streaming k-NN normals net overflow: %.1f%% of %d queries "
            "under-covered (bucket %d); re-solving exactly",
            100.0 * missing.mean(), len(missing), _NET_BUCKET,
        )
        from ..ops.grid_hash import pad_pow2_bucket

        mj = jnp.asarray(pad_pow2_bucket(np.nonzero(missing)[0]))
        fix = knn_auto(q[mj], c, k)
        pre_m = None if pre is None else pre[mj]
        fixed = _normals_from_neighborhoods(q[mj], c, fix, pre_m)
        normals = normals.at[mj].set(fixed)
    return normals


@jax.jit
def _normals_from_neighborhoods(query_points, cloud_points, nbr, pre_computed_normals):
    pts = cloud_points[nbr.idx]
    _, v, _ = pca_eigh(pts, nbr.mask)
    normals = v[..., :, 0]  # eigenvector of the smallest eigenvalue
    if pre_computed_normals is not None:
        flip = jnp.sum(normals * pre_computed_normals, axis=-1) < 0
        normals = jnp.where(flip[..., None], -normals, normals)
    return normals


@functools.partial(jax.jit, static_argnames=("k_max",))
def _normals_radius(query_points, cloud_points, radius, k_max, pre_computed_normals):
    nbr = radius_search(query_points, cloud_points, radius, k_max)
    pts = cloud_points[nbr.idx]
    _, v, _ = pca_eigh(pts, nbr.mask)
    normals = v[..., :, 0]
    if pre_computed_normals is not None:
        flip = jnp.sum(normals * pre_computed_normals, axis=-1) < 0
        normals = jnp.where(flip[..., None], -normals, normals)
    return normals


def compute_normals(
    query_points,
    cloud_points,
    *,
    k: int | None = None,
    radius: float | None = None,
    pre_computed_normals=None,
    k_max: int = 64,
    mesh=None,
):
    """PCA normals (reference ``compute_normals``,
    pca_based_descriptors.py:29-59): normal = smallest-eigenvalue eigenvector
    of the neighborhood covariance, optionally sign-aligned to
    ``pre_computed_normals``.

    With a multi-device ``mesh`` the query axis shards over it
    (``parallel.sharded.sharded_normals``)."""
    assert k is not None or radius is not None, "Provide k or radius."
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.sharded import sharded_normals

        return sharded_normals(
            query_points, cloud_points, mesh,
            k=k, radius=radius,
            pre_computed_normals=pre_computed_normals, k_max=k_max,
        )
    # large inputs ride the content-keyed upload cache: repeat calls over the
    # same cloud (and query==cloud aliasing, the get_data default) skip the
    # ~12 MB/array h2d re-upload
    from ..utils.device_cache import to_device_cached

    q = to_device_cached(query_points)
    c = to_device_cached(cloud_points)
    pre = None if pre_computed_normals is None else to_device_cached(pre_computed_normals)
    if k is not None:
        if c.shape[0] >= AUTO_GRID_MIN_POINTS:
            # streaming covariance with adaptive per-query radii: removes the
            # top-k selection that dominated 1M-point normals (VERDICT r3 #3)
            return _streaming_knn_normals(
                q, c, k, pre,
                c_host=cloud_points if isinstance(cloud_points, np.ndarray)
                else None)
        return _normals_knn(q, c, k, pre)
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        # fused path: covariance reduced over the candidate window directly —
        # no top-k / k_max cap, ALL in-radius neighbors contribute
        grid = build_grid(_grid_pts(cloud_points, c), float(radius))
        cov, _, _ = grid_radius_pca(grid, q, radius)
        return _normals_from_cov(cov, pre)
    return _normals_radius(q, c, radius, k_max, pre)


@jax.jit
def _normals_from_cov(cov, pre_computed_normals):
    _, v = eigh3x3(cov)
    normals = v[..., :, 0]
    if pre_computed_normals is not None:
        flip = jnp.sum(normals * pre_computed_normals, axis=-1) < 0
        normals = jnp.where(flip[..., None], -normals, normals)
    return normals


def compute_sphericity(query_points, cloud_points, radius, k_max: int = 64):
    """λ_min / (λ_max + 1e-6) on radius neighborhoods
    (reference pca_based_descriptors.py:62-74).

    Large clouds go through the grid engine's fused covariance reduction
    (uncapped, no O(Q·N) brute pass)."""
    q = jnp.asarray(query_points, jnp.float32)
    c = jnp.asarray(cloud_points, jnp.float32)
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        grid = build_grid(_grid_pts(cloud_points, c), float(radius))
        cov, _, _ = grid_radius_pca(grid, q, radius)
        w, _ = eigh3x3(cov)
        return w[..., 0] / (w[..., 2] + 1e-6)
    return _sphericity_brute(q, c, radius, k_max)


@functools.partial(jax.jit, static_argnames=("k_max",))
def _sphericity_brute(q, c, radius, k_max: int):
    nbr = radius_search(q, c, radius, k_max)
    w, _, _ = pca_eigh(c[nbr.idx], nbr.mask)
    return w[..., 0] / (w[..., 2] + 1e-6)


def local_pca_with_moments(query_points, cloud_points, radius, k_max: int = 64):
    """Batched local PCA + first/second moments
    (reference ``compute_local_pca_with_moments``,
    pca_based_descriptors.py:77-147).

    Deviation: moments project the centered neighborhood onto the eigenvector
    *columns* (the intended basis); the reference uses ``@ eigenvectors.T``
    (line 131), an apparent transposition slip.
    Returns (eigenvalues (Q,3), eigenvectors (Q,3,3), moments (Q,8), sizes (Q,)).

    Large clouds run over grouped feature-planar windows (uncapped, exact —
    the brute path at any size would be an O(Q·N) matmul)."""
    q = jnp.asarray(query_points, jnp.float32)
    c = jnp.asarray(cloud_points, jnp.float32)
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        grid = build_grid(_grid_pts(cloud_points, c), float(radius) / 2, halo=2)
        return _pca_moments_window(grid, q, radius)
    return _pca_moments_brute(q, c, radius, k_max)


@jax.jit
def _pca_moments_window(grid, q, radius):
    """Feature-planar window formulation of ``local_pca_with_moments``."""
    from ..ops.grid_hash import window_distances

    vals, d, win_ok, _rows = window_distances(grid, q)
    ok = win_ok & (d <= radius)
    okf = ok.astype(jnp.float32)
    count = jnp.maximum(jnp.sum(okf, axis=-1), 1.0)
    # accumulate query-centered (|p - q| <= radius) so f32 stays accurate for
    # clouds far from the origin, then re-center about the barycenter
    rel = jnp.where(ok[:, None, :], vals[:, :3, :] - q[:, :, None], 0.0)
    bary_off = jnp.sum(rel, axis=-1) / count[:, None]
    centered = jnp.where(ok[:, None, :], rel - bary_off[:, :, None], 0.0)
    cov = jnp.einsum("qiw,qjw->qij", centered, centered) / count[:, None, None]
    w, v = eigh3x3(cov)
    proj = jnp.einsum("qiw,qij->qjw", centered, v)
    mean_abs = jnp.abs(jnp.sum(proj, axis=-1) / count[:, None])
    mean_sq = jnp.sum(proj**2, axis=-1) / count[:, None]
    vert = centered[:, 2, :]
    vert_mean = jnp.sum(vert, axis=-1) / count
    vert_sq = jnp.sum(vert**2, axis=-1) / count
    moments = jnp.concatenate(
        [mean_abs, mean_sq, vert_mean[:, None], vert_sq[:, None]], axis=1
    )
    return w, v, moments, jnp.sum(ok, axis=-1)


@functools.partial(jax.jit, static_argnames=("k_max",))
def _pca_moments_brute(q, c, radius, k_max: int):
    nbr = radius_search(q, c, radius, k_max)
    pts = c[nbr.idx]
    w, v, bary = pca_eigh(pts, nbr.mask)
    m = nbr.mask.astype(jnp.float32)
    count = jnp.maximum(jnp.sum(m, axis=-1), 1.0)

    centered = (pts - bary[..., None, :]) * m[..., None]
    proj = jnp.einsum("qki,qij->qkj", centered, v)  # coords in eigenbasis
    mean_abs = jnp.abs(jnp.sum(proj, axis=1) / count[:, None])
    mean_sq = jnp.sum(proj**2, axis=1) / count[:, None]
    vert = centered[..., 2]
    vert_mean = jnp.sum(vert, axis=1) / count
    vert_sq = jnp.sum(vert**2, axis=1) / count
    moments = jnp.concatenate(
        [mean_abs, mean_sq, vert_mean[:, None], vert_sq[:, None]], axis=1
    )
    return w, v, moments, jnp.sum(nbr.mask, axis=-1)


def compute_pca_based_basic_features(query_points, cloud_points, radius, k_max: int = 64):
    """(verticality, linearity, planarity, sphericity)
    (reference pca_based_descriptors.py:150-184).  Large clouds use the
    grid engine's fused covariance (uncapped)."""
    q = jnp.asarray(query_points, jnp.float32)
    c = jnp.asarray(cloud_points, jnp.float32)
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        grid = build_grid(_grid_pts(cloud_points, c), float(radius))
        cov, _, _ = grid_radius_pca(grid, q, radius)
        w, v = eigh3x3(cov)
    else:
        nbr = radius_search(q, c, radius, k_max)
        w, v, _ = pca_eigh(c[nbr.idx], nbr.mask)
    lbd3, lbd2, lbd1 = w[..., 0], w[..., 1], w[..., 2] + 1e-6
    normals = v[..., :, 0]
    verticality = 2.0 * jnp.arcsin(jnp.clip(jnp.abs(normals[..., 2]), 0, 1)) / jnp.pi
    linearity = 1.0 - lbd2 / lbd1
    planarity = (lbd2 - lbd3) / lbd1
    sphericity = lbd3 / lbd1
    return verticality, linearity, planarity, sphericity


def compute_pca_based_features(query_points, cloud_points, radius, k_max: int = 64,
                               verbose: bool = False):
    """Full 21-column eigen-feature stack
    (reference ``compute_pca_based_features``, pca_based_descriptors.py:187-244).

    ``verbose`` logs the neighborhood-size statistics and renders their
    histogram through :func:`shot_fpfh_tpu.analysis.plot_neighborhood_sizes`
    (the reference's inline ``plt.hist``, pca_based_descriptors.py:105-119);
    it defaults to False here because it forces a device→host sync."""
    w, v, moments, sizes = local_pca_with_moments(query_points, cloud_points, radius, k_max)
    if verbose:
        from ..analysis import plot_neighborhood_sizes

        plot_neighborhood_sizes(np.asarray(sizes))
    lbd3, lbd2, lbd1 = w[..., 0], w[..., 1], w[..., 2] + 1e-6
    normals = v[..., :, 0]
    principal_axis = v[..., :, 2]

    eigensum = jnp.sum(w, axis=-1)
    eigen_square_sum = jnp.sum(w**2, axis=-1)
    omnivariance = jnp.cbrt(jnp.prod(w, axis=-1))
    eigenentropy = jnp.sum(-w * jnp.log(w + 1e-6), axis=-1)
    linearity = 1.0 - lbd2 / lbd1
    planarity = (lbd2 - lbd3) / lbd1
    sphericity = lbd3 / lbd1
    curvature_change = lbd3 / jnp.maximum(eigensum, 1e-12)
    arcsin = lambda x: 2.0 * jnp.arcsin(jnp.clip(jnp.abs(x), 0, 1)) / jnp.pi  # noqa: E731
    cols = [
        eigensum, eigen_square_sum, omnivariance, eigenentropy,
        linearity, planarity, sphericity, curvature_change,
        arcsin(normals[..., 2]), arcsin(principal_axis[..., 2]),
        arcsin(normals[..., 0]), arcsin(normals[..., 1]),
    ]
    return jnp.concatenate(
        [jnp.stack(cols, axis=1), moments, sizes[:, None].astype(jnp.float32)], axis=1
    )
