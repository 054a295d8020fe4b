"""SHOT descriptors (Signature of Histograms of OrienTations), batched formulation.

Parity target: the reference implementation of Salti/Tombari/Di Stefano's SHOT
(descriptors/shot.py, descriptors/shot_parallelization.py).  The reference
computes one keypoint per task in a ``multiprocessing.Pool``; here the whole
keypoint set is a single batched program: fixed-k masked neighborhoods, one
batched weighted-covariance eigendecomposition for the local reference frames,
and a vectorized quadrilinear soft-binning accumulated with
``ops.histogram.batched_histogram``.

Binning layout matches the reference exactly: 11 cosine x 8 azimuth x
2 elevation x 2 radial = 352 bins, with the same azimuth-octant convention
(shot.py:51-70), radial husks centered at r/4 and 3r/4 (shot.py:73-118),
elevation volumes centered at pi/4 and 3pi/4 (shot.py:121-171), cosine-bin
rounding via round-half-even, and wrap-around azimuth interpolation.

Documented deviation: the reference's fancy-index ``+=`` drops colliding
contributions within each statement (NumPy semantics); we accumulate all
contributions (``np.add.at`` semantics), which is the intended algorithm from
the SHOT paper.  Empty/sparse neighborhoods (≤ ``min_neighborhood_size``)
produce all-zero descriptors — the validity convention consumed by matching.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.subsampling import grid_subsample
# the bin conventions live in ops.descriptor_bins (single source of truth);
# re-exported here under their historic names
from ..ops.descriptor_bins import (
    N_AZ as N_AZIMUTH_BINS,
    N_COS as N_COSINE_BINS,
    N_ELEV as N_ELEVATION_BINS,
    N_RAD as N_RADIAL_BINS,
    SHOT_DIM,
    azimuth_bin as azimuth_bin_index,
    interpolate_husks,
    interpolate_vertical,
    shot_soft_bins,
)
from ..ops.eigh3 import eigh3x3
# histogram accumulation is SHOT-specialized below (_shot_bilinear_histogram)
from ..ops.grid_hash import radius_search_with_values_auto
from ..ops.neighbors import Neighborhoods, radius_search


# --------------------------------------------------------------- debug ------
# Counterpart of the reference's sequential-SHOT ``debug_mode`` asserts and
# interpolation-sanity warnings (shot.py:375-379,414-428,441-463): when
# enabled, every SHOT accumulation validates its bin indices and quadrilinear
# weights on device (two masked reductions) and reports violations through a
# host callback.  Off by default — the checks are free-ish but pure paranoia.
_DEBUG = {"enabled": False, "violations": 0}


def enable_debug_checks(enabled: bool = True) -> None:
    """Toggle SHOT binning sanity checks (CLI ``--debug_shot``).

    The flag is read at TRACE time, so already-compiled SHOT programs are
    dropped from the jit cache to make the toggle effective immediately."""
    import jax as _jax

    if _DEBUG["enabled"] != enabled:
        _jax.clear_caches()
    _DEBUG["enabled"] = enabled
    _DEBUG["violations"] = 0


def debug_violation_count() -> int:
    return _DEBUG["violations"]


def _binning_violations(cos_bin, cos_nb, az_bin, elev_bin, rad_bin,
                        total_w, valid):
    """(bad-bin count, bad-weight count) over valid neighbors — the pure
    device-side predicate behind the debug checks.  A neighbor is unsound if
    any bin index leaves its range, or if its summed quadrilinear
    interpolation weight leaves (0, 4 + eps] (each of the four interpolation
    dimensions contributes at most 1 — reference shot.py:414-428)."""
    bad_bin = (
        (cos_bin < 0) | (cos_bin >= N_COSINE_BINS)
        | (cos_nb < 0) | (cos_nb >= N_COSINE_BINS)
        | (az_bin < 0) | (az_bin >= N_AZIMUTH_BINS)
        | (elev_bin < 0) | (elev_bin >= N_ELEVATION_BINS)
        | (rad_bin < 0) | (rad_bin >= N_RADIAL_BINS)
    )
    bad_w = jnp.isnan(total_w) | (total_w > 4.0 + 1e-3) | (total_w <= 0.0)
    return (jnp.sum(bad_bin & valid, dtype=jnp.int32),
            jnp.sum(bad_w & valid, dtype=jnp.int32))


def _debug_report(n_bad_bin, n_bad_weight):
    import logging

    n = int(n_bad_bin) + int(n_bad_weight)
    if n:
        _DEBUG["violations"] += n
        logging.getLogger(__name__).warning(
            "SHOT debug checks: %d out-of-range bin indices, %d unsound "
            "quadrilinear weight sums among valid neighbors",
            int(n_bad_bin), int(n_bad_weight),
        )


@jax.jit
def local_reference_frames(
    keypoints: jnp.ndarray,
    neighbor_points: jnp.ndarray,
    mask: jnp.ndarray,
    radius,
) -> jnp.ndarray:
    """Batched SHOT local reference frames (reference ``get_local_rf``,
    shot.py:16-48): eigenvectors of the (radius − d)-weighted covariance of the
    centered neighborhood, x/z sign-disambiguated by majority vote of neighbor
    projections, y = z x x; columns ordered [x, y, z] (descending eigenvalue).
    Empty neighborhoods yield the identity frame.
    """
    centered = neighbor_points - keypoints[:, None, :]
    m = mask.astype(jnp.float32)
    dist = jnp.linalg.norm(jnp.where(mask[..., None], centered, 0.0), axis=-1)
    w = jnp.maximum(radius - dist, 0.0) * m
    wsum = jnp.sum(w, axis=-1)
    cov = jnp.einsum("qki,qkj->qij", centered * w[..., None], centered) / jnp.maximum(
        wsum, 1e-12
    )[:, None, None]
    _, v = eigh3x3(cov)  # ascending eigenvalues

    x_axis = v[..., :, 2]
    z_axis = v[..., :, 0]
    proj_x = jnp.einsum("qki,qi->qk", centered, x_axis)
    neg = jnp.sum((proj_x < 0) & mask, axis=-1)
    nonneg = jnp.sum((proj_x >= 0) & mask, axis=-1)
    x_axis = jnp.where((neg > nonneg)[:, None], -x_axis, x_axis)
    proj_z = jnp.einsum("qki,qi->qk", centered, z_axis)
    neg = jnp.sum((proj_z < 0) & mask, axis=-1)
    nonneg = jnp.sum((proj_z >= 0) & mask, axis=-1)
    z_axis = jnp.where((neg > nonneg)[:, None], -z_axis, z_axis)
    y_axis = jnp.cross(z_axis, x_axis)

    rf = jnp.stack([x_axis, y_axis, z_axis], axis=-1)  # columns [x, y, z]
    empty = jnp.sum(mask, axis=-1) == 0
    return jnp.where(empty[:, None, None], jnp.eye(3, dtype=rf.dtype), rf)


def _shot_bilinear_histogram(groups, valid, chunk: int = 512) -> jnp.ndarray:
    """Σ over groups of ``onehot(hi) ⊗ Σ_t w_t·onehot(lo_t)`` — the SHOT
    accumulation with the cell-side one-hots pre-summed per shared hi index
    (elementwise adds), so the contraction width is K per group instead of
    K x n_terms.

    ``groups``: list of (idx_hi (Q, K), [(idx_lo (Q, K), w (Q, K)), ...]).
    Returns (Q, 352) float32."""
    n_lo = N_AZIMUTH_BINS * N_ELEVATION_BINS * N_RADIAL_BINS
    q, m = valid.shape
    # One-shot (single scan step) whenever the (Q, m, 32) one-hot operand
    # fits a ~1 GB budget: the chunked scan re-streams the cell-side operand
    # through device memory once per chunk.  The scan stays for at-scale
    # windows that would not fit.
    if q * m * n_lo * 4 <= 1 << 30:
        chunk = max(chunk, m)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m

    def prep(x, fill=0):
        x = jnp.pad(x, ((0, 0), (0, pad)), constant_values=fill)
        return jnp.moveaxis(x.reshape(q, n_chunks, -1), 1, 0)

    valid_p = prep(valid.astype(jnp.float32))
    flat = []
    for hi, terms in groups:
        flat.append(prep(hi))
        for lo_idx, w in terms:
            flat.append(prep(lo_idx))
            flat.append(prep(w.astype(jnp.float32)))

    bins_hi = jnp.arange(N_COSINE_BINS, dtype=jnp.int32)
    bins_lo = jnp.arange(n_lo, dtype=jnp.int32)

    def body(acc, args):
        v_c, rest = args[0], list(args[1:])
        for hi, terms in groups:
            hi_c = rest.pop(0)
            b = None
            for _ in terms:
                lo_c = rest.pop(0)
                w_c = rest.pop(0) * v_c
                t = (lo_c[:, :, None] == bins_lo).astype(jnp.float32) * w_c[:, :, None]
                b = t if b is None else b + t
            # f32 operands: bf16 cell-side weights would round ~2^-8 per
            # term, and values one ulp apart on two backends can round to
            # different bf16 neighbours (a 1e-4 change of a normalized
            # descriptor between the GPU and the CPU)
            a = (hi_c[:, :, None] == bins_hi).astype(jnp.float32)
            acc = acc + jnp.einsum(
                "qmh,qml->qhl", a, b, preferred_element_type=jnp.float32,
            )
        return acc, None

    acc0 = jnp.zeros((q, N_COSINE_BINS, n_lo), jnp.float32) + jnp.sum(valid_p) * 0.0
    acc, _ = jax.lax.scan(body, acc0, tuple([valid_p] + flat))
    return acc.reshape(q, N_COSINE_BINS * n_lo)


@functools.partial(jax.jit, static_argnames=("normalize", "min_neighborhood_size"))
def shot_from_neighborhoods(
    keypoints: jnp.ndarray,
    neighbor_points: jnp.ndarray,
    neighbor_normals: jnp.ndarray,
    mask: jnp.ndarray,
    local_rfs: jnp.ndarray,
    radius,
    normalize: bool = True,
    min_neighborhood_size: int = 100,
) -> jnp.ndarray:
    """The 352-bin quadrilinear accumulation given gathered neighborhoods.

    Mirrors ``compute_single_shot_descriptor`` (shot.py:175-306) with true
    accumulation semantics; all four interpolations (cosine, radial husk,
    elevation volume, azimuth wrap-around) are applied per neighbor, masked by
    validity, and scatter-added into per-keypoint histograms in one call.
    """
    centered = neighbor_points - keypoints[:, None, :]
    rho = jnp.linalg.norm(jnp.where(mask[..., None], centered, 0.0), axis=-1)
    valid = mask & (rho > 0)

    local = jnp.einsum("qki,qij->qkj", centered, local_rfs)
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    cosine = jnp.clip(
        jnp.einsum("qki,qi->qk", neighbor_normals, local_rfs[..., :, 2]), -1.0, 1.0
    )

    return _shot_accumulate(lx, ly, lz, rho, cosine, valid, radius,
                            normalize, min_neighborhood_size)


def _shot_finalize(desc, count, normalize, min_neighborhood_size):
    """Shared tail: L2-normalize and zero out invalid descriptors (the
    reference's ≤ min_neighborhood_size zero-descriptor convention,
    shot.py:212,306)."""
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    keep = (count > min_neighborhood_size)[:, None] & (norm > 0)
    if normalize:
        desc = desc / jnp.where(norm > 0, norm, 1.0)
    return jnp.where(keep, desc, 0.0)


def _shot_accumulate(lx, ly, lz, rho, cosine, valid, radius,
                     normalize, min_neighborhood_size):
    """Binning + histogram + normalization from per-neighbor (Q, K) scalars
    (local-RF coordinates, distance, normal-cosine, validity) — shared by the
    gathered-neighborhood and dense-window SHOT entry points."""
    rho_safe = jnp.where(valid, rho, 1.0)
    theta = jnp.arctan2(ly, lx)
    phi = jnp.arccos(jnp.clip(lz / rho_safe, -1.0, 1.0))
    sb = shot_soft_bins(lx, ly, lz, rho, theta, phi, cosine, radius)

    # The 352-bin space factorizes as 11 cosine bins x 32 spatial cells
    # (azimuth*4 + elevation*2 + radial) and the scatter-add becomes a
    # factored one-hot contraction (a batched matmul).  ``shot_soft_bins``'s merged
    # terms cut the contraction from the naive 10K width (10 contributions x
    # K neighbors) to 2K:
    #   1. the four contributions that land in the SAME (cos_bin, cell) pair
    #      — cosine-current, husk-current, volume-current, azimuth-current —
    #      merge into one summed weight (``w_same``);
    #   2. nine of the ten contributions share the cos_bin one-hot, so their
    #      cell-side one-hots sum FIRST (elementwise adds) and contract once; only
    #      the cosine-neighbor term needs the second (cos_nb) one-hot.
    cos_bin_terms = [
        (sb.base, sb.w_same),
        (sb.lo_husk, sb.w_husk_nb),
        (sb.lo_vert, sb.w_vert_nb),
        (sb.lo_az, sb.abs_az),
    ]
    cos_nb_terms = [(sb.base, sb.abs_cos)]

    if _DEBUG["enabled"]:  # trace-time flag; enable_debug_checks clears caches
        total_w = sb.w_same + sb.w_husk_nb + sb.w_vert_nb + sb.abs_az + sb.abs_cos
        n_bad_bin, n_bad_w = _binning_violations(
            sb.cos_bin, sb.cos_nb, sb.az_bin, sb.elev_bin, sb.rad_bin,
            total_w, valid
        )
        jax.debug.callback(_debug_report, n_bad_bin, n_bad_w)
    desc = _shot_bilinear_histogram(
        [(sb.cos_bin, cos_bin_terms), (sb.cos_nb, cos_nb_terms)], valid
    )
    return _shot_finalize(desc, jnp.sum(valid, axis=-1), normalize,
                          min_neighborhood_size)


def _local_rfs_ff(centered, rho, ok, radius):
    """Feature-first local reference frames (same math as
    ``local_reference_frames``: (radius-d)-weighted covariance, majority sign
    votes, y = z x x, identity for empty neighborhoods) on (Q, 3, W)
    centered offsets + (Q, W) distances/validity."""
    w = jnp.maximum(radius - rho, 0.0) * ok.astype(jnp.float32)
    wsum = jnp.sum(w, axis=-1)
    cov = jnp.einsum("qiw,qjw->qij", centered * w[:, None, :], centered) / (
        jnp.maximum(wsum, 1e-12)[:, None, None]
    )
    _, v = eigh3x3(cov)
    x_axis = v[..., :, 2]
    z_axis = v[..., :, 0]
    proj_x = jnp.einsum("qiw,qi->qw", centered, x_axis)
    neg = jnp.sum((proj_x < 0) & ok, axis=-1)
    nonneg = jnp.sum((proj_x >= 0) & ok, axis=-1)
    x_axis = jnp.where((neg > nonneg)[:, None], -x_axis, x_axis)
    proj_z = jnp.einsum("qiw,qi->qw", centered, z_axis)
    neg = jnp.sum((proj_z < 0) & ok, axis=-1)
    nonneg = jnp.sum((proj_z >= 0) & ok, axis=-1)
    z_axis = jnp.where((neg > nonneg)[:, None], -z_axis, z_axis)
    y_axis = jnp.cross(z_axis, x_axis)
    rfs = jnp.stack([x_axis, y_axis, z_axis], axis=-1)
    empty = jnp.sum(ok, axis=-1) == 0
    return jnp.where(empty[:, None, None], jnp.eye(3, dtype=rfs.dtype), rfs)


@functools.partial(jax.jit, static_argnames=("normalize", "min_neighborhood_size"))
def shot_from_window_ff(
    keypoints: jnp.ndarray,
    window_vals: jnp.ndarray,
    window_dist: jnp.ndarray,
    radius,
    normalize: bool = True,
    min_neighborhood_size: int = 100,
    local_rfs=None,
    rf_dist_inf=None,
    rf_radius=None,
):
    """SHOT from a dense FEATURE-FIRST candidate window (the layout
    ``ops.grid_hash.window_distances`` returns).

    ``window_vals``: (Q, 8, W) ``[x y z nx ny nz 0 0]`` rows; ``window_dist``:
    (Q, W) distance-or-+inf.  The feature-first layout keeps every
    interpolation a (Q, W) elementwise op with no (Q, W, 8) transpose
    between the fetch and the einsums.
    No k cap — the EXACT uncapped radius neighborhood contributes, like the
    reference's (descriptors/shot.py:175-306).

    Bi-scale (reference shot_parallelization.py:185-239): pass
    ``rf_dist_inf``/``rf_radius`` to compute the local frames from a
    DIFFERENT validity plane over the same window (mutually exclusive with
    ``local_rfs``)."""
    ok = jnp.isfinite(window_dist)
    okf = ok.astype(jnp.float32)
    pts = window_vals[:, :3, :]
    nrms = jnp.where(ok[:, None, :], window_vals[:, 3:6, :], 0.0)
    centered = jnp.where(ok[:, None, :], pts - keypoints[:, :, None], 0.0)
    rho = jnp.where(ok, window_dist, 0.0)

    if local_rfs is not None:
        rfs = local_rfs
    elif rf_dist_inf is not None:
        ok_rf = jnp.isfinite(rf_dist_inf)
        centered_rf = jnp.where(ok_rf[:, None, :],
                                pts - keypoints[:, :, None], 0.0)
        rfs = _local_rfs_ff(centered_rf, jnp.where(ok_rf, rf_dist_inf, 0.0),
                            ok_rf, rf_radius)
    else:
        rfs = _local_rfs_ff(centered, rho, ok, radius)

    local = jnp.einsum("qiw,qij->qjw", centered, rfs)
    lx, ly, lz = local[:, 0, :], local[:, 1, :], local[:, 2, :]
    cosine = jnp.clip(
        jnp.einsum("qiw,qi->qw", nrms, rfs[..., :, 2]), -1.0, 1.0
    )
    valid = ok & (rho > 0)
    desc = _shot_accumulate(lx, ly, lz, rho, cosine, valid, radius,
                            normalize, min_neighborhood_size)
    return desc, rfs


@functools.partial(jax.jit, static_argnames=("normalize", "min_neighborhood_size"))
def _shot_from_values(kp, nb_pts, nb_nrm, mask, local_rfs, radius, normalize,
                      min_neighborhood_size):
    """Local-RF + histogram on pre-gathered neighborhoods (one program)."""
    if local_rfs is None:
        local_rfs = local_reference_frames(kp, nb_pts, mask, radius)
    desc = shot_from_neighborhoods(
        kp, nb_pts, nb_nrm, mask, local_rfs, radius,
        normalize=normalize, min_neighborhood_size=min_neighborhood_size,
    )
    return desc, local_rfs


@functools.partial(
    jax.jit,
    static_argnames=("normalize", "min_neighborhood_size", "chunk", "has_rfs"),
)
def _shot_window_chunked(grid, kp, local_rfs, radius, normalize,
                         min_neighborhood_size, chunk: int = 4096,
                         has_rfs: bool = False, rf_radius=None):
    """Grid-window SHOT: per query chunk, gather the full compacted candidate
    window, mask by radius, and run LRF + histogram over the window directly —
    NO top-k and NO k_max truncation (3000/4096 bench neighborhoods exceeded
    the 256 cap), so the result is the exact uncapped-neighborhood SHOT the
    reference computes, and the selection cost disappears.
    """
    from ..ops.grid_hash import window_distances

    q = kp.shape[0]
    n_chunks = -(-q // chunk)
    padded = n_chunks * chunk
    kp_p = jnp.pad(kp, ((0, padded - q), (0, 0)), constant_values=1.0e6)
    if has_rfs:
        rfs_p = jnp.pad(local_rfs, ((0, padded - q), (0, 0), (0, 0)))
        args = (kp_p.reshape(n_chunks, chunk, 3),
                rfs_p.reshape(n_chunks, chunk, 3, 3))
    else:
        args = (kp_p.reshape(n_chunks, chunk, 3),)

    def one(chunk_args):
        qc = chunk_args[0]
        vals, d, valid, _rows = window_distances(grid, qc)  # (C, F, W)
        rfs_in = chunk_args[1] if has_rfs else None
        rf_dist_inf = None
        if rfs_in is None and rf_radius is not None:
            # bi-scale: frames from the rf_radius neighborhood of the SAME
            # window (the grid covers max(radius, rf_radius))
            rf_dist_inf = jnp.where(valid & (d <= rf_radius), d, jnp.inf)
        dist_inf = jnp.where(valid & (d <= radius), d, jnp.inf)
        return shot_from_window_ff(
            qc, vals, dist_inf, radius,
            normalize=normalize, min_neighborhood_size=min_neighborhood_size,
            local_rfs=rfs_in, rf_dist_inf=rf_dist_inf,
            rf_radius=rf_radius if rf_dist_inf is not None else None,
        )

    desc, rfs = jax.lax.map(one, args)
    return (desc.reshape(padded, -1)[:q],
            rfs.reshape(padded, 3, 3)[:q])


def compute_shot_descriptor(
    keypoints,
    support_points,
    support_normals,
    radius,
    *,
    k_max: int = 512,
    normalize: bool = True,
    min_neighborhood_size: int = 100,
    local_rfs=None,
    local_rf_neighborhoods: Neighborhoods | None = None,
):
    """Single-scale SHOT on a support cloud.  Returns ((Q, 352) descriptors,
    local RFs) so multiscale drivers can share frames across scales.

    Large supports go through the grid engine's full-window formulation
    (``_shot_window_chunked``): exact uncapped neighborhoods, no top-k."""
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    kp = jnp.asarray(keypoints, jnp.float32)
    n_sup = np.shape(support_points)[0]
    if n_sup >= AUTO_GRID_MIN_POINTS and local_rf_neighborhoods is None:
        # host-side conversion straight from the caller's arrays (usually
        # already numpy) so build_grid's content cache can engage without a
        # device round trip
        grid = build_grid(np.asarray(support_points, np.float32),
                          float(radius) / 2,
                          extras=np.asarray(support_normals, np.float32),
                          halo=2)
        desc, rfs = _shot_window_chunked(
            grid, kp, local_rfs, radius, normalize, min_neighborhood_size,
            has_rfs=local_rfs is not None,
        )
        return desc, rfs
    # Small supports: brute-force masked search (one matmul beats grid
    # build), with neighbor points AND normals gathered together.
    sup = jnp.asarray(support_points, jnp.float32)
    nrm = jnp.asarray(support_normals, jnp.float32)
    nbr, vals = radius_search_with_values_auto(kp, sup, nrm, radius, k_max)
    if local_rfs is None and local_rf_neighborhoods is not None:
        rf_nbr = local_rf_neighborhoods
        local_rfs = local_reference_frames(kp, sup[rf_nbr.idx], rf_nbr.mask, radius)
    return _shot_from_values(
        kp, vals[..., :3], vals[..., 3:6], nbr.mask, local_rfs, radius,
        normalize, min_neighborhood_size,
    )


class ShotComputer:
    """Single/bi/multi-scale SHOT drivers — the batched replacement for the
    reference's ``ShotMultiprocessor`` (shot_parallelization.py:16-312).

    Where the reference fans keypoints out over a process pool, every scale
    here is one batched device program; "parallelism" is the keypoint batch
    axis, which also shards over a device mesh (see ``parallel.sharded``).
    """

    def __init__(
        self,
        normalize: bool = True,
        share_local_rfs: bool = True,
        min_neighborhood_size: int = 100,
        k_max: int = 512,
        verbose: bool = True,
        pad_queries_to: int = 1024,
        mesh=None,
    ):
        self.normalize = normalize
        self.share_local_rfs = share_local_rfs
        self.min_neighborhood_size = min_neighborhood_size
        self.k_max = k_max
        self.verbose = verbose
        # Shape bucketing: keypoint sets are padded to a multiple of this with
        # a far-away sentinel (empty neighborhood -> zero descriptor), so
        # scan/ref and successive pairs reuse one compiled program per bucket.
        self.pad_queries_to = pad_queries_to
        # Multi-chip: a jax.sharding.Mesh routes every scale through
        # parallel.sharded (keypoint-sharded shard_map) — the device counterpart
        # of the reference's n_procs actually driving its pool
        # (shot_parallelization.py:31).
        self.mesh = mesh

    def _use_mesh(self) -> bool:
        return self.mesh is not None and self.mesh.devices.size > 1

    def _support(self, point_cloud, normals, voxel_size):
        if voxel_size is None:
            return point_cloud, normals
        sel = grid_subsample(point_cloud, voxel_size)
        return np.asarray(point_cloud)[sel], np.asarray(normals)[sel]

    def _pad(self, keypoints):
        kp = np.asarray(keypoints, np.float32)
        m = max(self.pad_queries_to, 1)
        padded = ((len(kp) + m - 1) // m) * m
        if padded == len(kp):
            return kp, len(kp)
        far = np.full((padded - len(kp), 3), 1.0e6, np.float32)
        return np.concatenate([kp, far]), len(kp)

    def compute_descriptor_single_scale(
        self, point_cloud, normals, keypoints, radius, subsampling_voxel_size=None
    ):
        sup, nrm = self._support(point_cloud, normals, subsampling_voxel_size)
        kp, n_kp = self._pad(keypoints)
        if self._use_mesh():
            from ..parallel.sharded import sharded_shot_descriptors

            desc = sharded_shot_descriptors(
                kp, sup, nrm, radius, self.mesh,
                k_max=self.k_max, normalize=self.normalize,
                min_neighborhood_size=self.min_neighborhood_size,
            )
            return desc[:n_kp]
        desc, _ = compute_shot_descriptor(
            kp, sup, nrm, radius,
            k_max=self.k_max, normalize=self.normalize,
            min_neighborhood_size=self.min_neighborhood_size,
        )
        return desc[:n_kp]

    def compute_descriptor_bi_scale(
        self,
        point_cloud,
        normals,
        keypoints,
        local_rf_radius,
        shot_radius,
        subsampling_voxel_size=None,
    ):
        """Local RFs from ``local_rf_radius`` neighborhoods, descriptor from
        ``shot_radius`` neighborhoods (reference
        shot_parallelization.py:185-239 — including its guard-less second
        query, fixed here to respect ``subsampling_voxel_size=None``)."""
        sup, nrm = self._support(point_cloud, normals, subsampling_voxel_size)
        kp_np, n_kp = self._pad(keypoints)
        if self._use_mesh():
            from ..parallel.sharded import sharded_shot_descriptors

            desc = sharded_shot_descriptors(
                kp_np, sup, nrm, shot_radius, self.mesh,
                k_max=self.k_max, normalize=self.normalize,
                min_neighborhood_size=self.min_neighborhood_size,
                rf_radius=local_rf_radius,
            )
            return desc[:n_kp]
        from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

        if np.asarray(sup).shape[0] >= AUTO_GRID_MIN_POINTS:
            # large supports: grouped-window formulation (brute radius_search
            # for the RFs would be an O(Q*N) matmul + N-wide top_k at 1M)
            max_r = float(max(local_rf_radius, shot_radius))
            grid = build_grid(np.asarray(sup, np.float32), max_r / 2,
                              extras=np.asarray(nrm, np.float32), halo=2)
            desc, _ = _shot_window_chunked(
                grid, jnp.asarray(kp_np), None, shot_radius, self.normalize,
                self.min_neighborhood_size, rf_radius=local_rf_radius,
            )
            return desc[:n_kp]
        kp = jnp.asarray(kp_np)
        supj = jnp.asarray(sup, jnp.float32)
        rf_nbr = radius_search(kp, supj, local_rf_radius, self.k_max)
        rfs = local_reference_frames(kp, supj[rf_nbr.idx], rf_nbr.mask, local_rf_radius)
        desc, _ = compute_shot_descriptor(
            kp, supj, jnp.asarray(nrm, jnp.float32), shot_radius,
            k_max=self.k_max, normalize=self.normalize,
            min_neighborhood_size=self.min_neighborhood_size, local_rfs=rfs,
        )
        return desc[:n_kp]

    def compute_descriptor_multiscale(
        self, point_cloud, normals, keypoints, radii, voxel_sizes=None, weights=None
    ):
        """Concatenated per-scale descriptors (Q, 352·n_scales); optionally the
        first (smallest-radius) scale's local RFs are shared across scales
        (reference shot_parallelization.py:241-312)."""
        if weights is None:
            weights = [1.0] * len(radii)
        descs = []
        shared_rfs = None
        kp, n_kp = self._pad(keypoints)
        if self._use_mesh():
            from ..parallel.sharded import sharded_shot_descriptors

            for scale, radius in enumerate(radii):
                voxel = None if voxel_sizes is None else voxel_sizes[scale]
                sup, nrm = self._support(point_cloud, normals, voxel)
                desc, rfs = sharded_shot_descriptors(
                    kp, sup, nrm, radius, self.mesh,
                    k_max=self.k_max, normalize=self.normalize,
                    min_neighborhood_size=self.min_neighborhood_size,
                    shared_rfs=shared_rfs, return_rfs=True,
                )
                if self.share_local_rfs and shared_rfs is None:
                    shared_rfs = rfs  # stays row-sharded on the mesh
                descs.append(desc * weights[scale])
            return np.concatenate(descs, axis=1)[:n_kp]
        for scale, radius in enumerate(radii):
            voxel = None if voxel_sizes is None else voxel_sizes[scale]
            sup, nrm = self._support(point_cloud, normals, voxel)
            desc, rfs = compute_shot_descriptor(
                kp, sup, nrm, radius,
                k_max=self.k_max, normalize=self.normalize,
                min_neighborhood_size=self.min_neighborhood_size,
                local_rfs=shared_rfs,
            )
            if self.share_local_rfs and shared_rfs is None:
                shared_rfs = rfs
            descs.append(desc * weights[scale])
        return jnp.concatenate(descs, axis=1)[:n_kp]
