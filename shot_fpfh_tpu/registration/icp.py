"""ICP fine registration as a bounded ``lax.while_loop``.

Replaces the reference's Python iteration loops (icp.py:81-189): the scan is
grid-subsampled once (outside jit, fixed size thereafter); each iteration does
a 1-NN query into ref (tiled matmul argmin), masks inliers at ``d_max``, runs
the mask-weighted solver, composes the transform, and stops early on the RMS
threshold — all with static shapes, so the whole ICP is one device program.

Documented deviations (SURVEY.md §2.4.2): the reference's point-to-point RMS
mixes inliers with all neighbors (shape-mismatched broadcast) and takes
sqrt-of-sum instead of sqrt-of-mean; we compute the proper inlier RMS.  The
point-to-plane RMS (mean |residual| over inliers) matches the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.solvers import solve_point_to_plane, solve_point_to_point
from ..core.subsampling import grid_subsample
from ..core.transform import RigidTransform
from ..ops.neighbors import nearest_neighbor


class IcpResult(NamedTuple):
    transform: RigidTransform
    rms: jnp.ndarray
    has_converged: jnp.ndarray
    n_iters: jnp.ndarray


def _icp_loop(scan_sub, ref, ref_normals, init: RigidTransform, d_max, max_iter,
              rms_threshold, point_to_plane: bool, grid=None):
    def _nn(moved):
        if grid is not None:
            # grid 1-NN with cell_size == d_max is exact for ICP: any true NN
            # farther than d_max is past the inlier cut anyway
            from ..ops.grid_hash import grid_nearest_neighbor

            return grid_nearest_neighbor(grid, moved)
        return nearest_neighbor(moved, ref)

    def body(state):
        i, rot, t, _rms, _done = state
        tf = RigidTransform(rot, t)
        moved = tf.apply(scan_sub)
        dist, nn = _nn(moved)
        w = (dist <= d_max).astype(jnp.float32)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        target = ref[nn]
        if point_to_plane:
            delta = solve_point_to_plane(moved, target, ref_normals[nn], w)
            residual = jnp.abs(jnp.sum((moved - target) * ref_normals[nn], axis=-1))
            rms = jnp.sum(residual * w) / wsum
        else:
            delta = solve_point_to_point(moved, target, w)
            # grid 1-NN reports inf for window-miss queries; their w is 0 but
            # 0 * inf**2 would still poison the RMS with NaN
            safe = jnp.where(w > 0, dist, 0.0)
            rms = jnp.sqrt(jnp.sum(w * safe**2) / wsum)
        composed = delta @ tf
        done = rms < rms_threshold
        return i + 1, composed.rotation, composed.translation, rms, done

    def cond(state):
        i, _rot, _t, _rms, done = state
        return (i < max_iter) & (~done)

    state = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(init.rotation, jnp.float32),
        jnp.asarray(init.translation, jnp.float32),
        jnp.asarray(jnp.inf, jnp.float32),
        jnp.asarray(False),
    )
    i, rot, t, rms, done = jax.lax.while_loop(cond, body, state)
    return IcpResult(RigidTransform(rot, t), rms, done, i)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def icp_point_to_point_jit(scan_sub, ref, init_rot, init_t, d_max, max_iter,
                           rms_threshold, grid=None):
    return _icp_loop(
        jnp.asarray(scan_sub, jnp.float32),
        jnp.asarray(ref, jnp.float32),
        None,
        RigidTransform(init_rot, init_t),
        d_max, max_iter, rms_threshold, point_to_plane=False, grid=grid,
    )


@functools.partial(jax.jit, static_argnames=("max_iter",))
def icp_point_to_plane_jit(scan_sub, ref, ref_normals, init_rot, init_t, d_max,
                           max_iter, rms_threshold, grid=None):
    return _icp_loop(
        jnp.asarray(scan_sub, jnp.float32),
        jnp.asarray(ref, jnp.float32),
        jnp.asarray(ref_normals, jnp.float32),
        RigidTransform(init_rot, init_t),
        d_max, max_iter, rms_threshold, point_to_plane=True, grid=grid,
    )


def _maybe_grid(ref, d_max):
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    if ref.shape[0] >= AUTO_GRID_MIN_POINTS:
        # host arrays hit the content-keyed grid cache; device arrays build
        # uncached rather than paying a full-cloud d2h download just to hash
        pts = ref if isinstance(ref, jax.Array) else np.asarray(ref, np.float32)
        return build_grid(pts, float(d_max))
    return None


class IcpHostResult(NamedTuple):
    """Host-side ICP outcome: ``(transform, rms, has_converged, n_iters)``.

    DELIBERATE API extension over the reference's 3-tuple
    (icp.py:81-189): ``n_iters`` is appended so callers can observe early
    stopping — 3-element unpacking must add a fourth target (the reference
    never exposed the iteration count at all)."""

    transform: RigidTransform
    rms: float
    has_converged: bool
    n_iters: int


def _subsampled(scan, sub):
    """Scan rows at the subsample indices WITHOUT changing the data's side:
    a device-array scan gathers on device (np.asarray on it would download
    the full 12 MB cloud per call), a host array gathers on host (uploading
    only the subsampled rows)."""
    if isinstance(scan, jax.Array):
        return jnp.asarray(scan, jnp.float32)[jnp.asarray(sub)]
    return np.asarray(scan)[np.asarray(sub)]


def icp_point_to_point(
    scan,
    ref,
    transformation_init: RigidTransform,
    d_max: float,
    voxel_size: float = 0.2,
    max_iter: int = 100,
    rms_threshold: float = 1e-2,
) -> IcpHostResult:
    """Point-to-point ICP on a grid-subsampled scan
    (reference ``icp_point_to_point``, icp.py:81-130).

    Transfer-aware: ``scan``/``ref`` ride the content-keyed upload cache
    (``utils/device_cache.py``), so repeated calls over the same clouds skip
    the ~12 MB/array h2d re-uploads."""
    from ..utils.device_cache import to_device_cached

    scan_d = to_device_cached(scan)
    sub = grid_subsample(scan_d, voxel_size)
    res = icp_point_to_point_jit(
        _subsampled(scan_d, sub), to_device_cached(ref),
        jnp.asarray(transformation_init.rotation, jnp.float32),
        jnp.asarray(transformation_init.translation, jnp.float32),
        d_max, max_iter, rms_threshold, grid=_maybe_grid(ref, d_max),
    )
    return IcpHostResult(
        res.transform, float(res.rms), bool(res.has_converged), int(res.n_iters)
    )


def icp_point_to_plane(
    scan,
    ref,
    ref_normals,
    transformation_init: RigidTransform,
    d_max: float,
    voxel_size: float = 0.2,
    max_iter: int = 50,
    rms_threshold: float = 1e-2,
) -> IcpHostResult:
    """Point-to-plane ICP (reference ``icp_point_to_plane``, icp.py:133-189).

    Transfer-aware like :func:`icp_point_to_point` — scan/ref/normals ride
    the content-keyed upload cache."""
    from ..utils.device_cache import to_device_cached

    scan_d = to_device_cached(scan)
    sub = grid_subsample(scan_d, voxel_size)
    res = icp_point_to_plane_jit(
        _subsampled(scan_d, sub), to_device_cached(ref), to_device_cached(ref_normals),
        jnp.asarray(transformation_init.rotation, jnp.float32),
        jnp.asarray(transformation_init.translation, jnp.float32),
        d_max, max_iter, rms_threshold, grid=_maybe_grid(ref, d_max),
    )
    return IcpHostResult(
        res.transform, float(res.rms), bool(res.has_converged), int(res.n_iters)
    )


def icp_point_to_point_with_sampling(
    scan,
    ref,
    d_max: float,
    max_iter: int = 100,
    rms_threshold: float = 1e-2,
    sampling_limit: int = 100,
    key: jax.Array | None = None,
) -> tuple[np.ndarray, float, bool]:
    """Legacy random-sampling point-to-point variant
    (reference ``icp_point_to_point_with_sampling``, icp.py:20-78): each
    iteration aligns a fresh random subset and moves the full cloud; returns
    the moved points rather than a composed transform."""
    if key is None:
        key = jax.random.key(0)
    scan = jnp.asarray(scan, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    limit = min(sampling_limit, scan.shape[0])

    @functools.partial(jax.jit, static_argnames=())
    def one_iter(points, k):
        idx = jax.random.choice(k, scan.shape[0], shape=(limit,), replace=False)
        subset = points[idx]
        dist, nn = nearest_neighbor(subset, ref)
        w = (dist <= d_max).astype(jnp.float32)
        tf = solve_point_to_point(subset, ref[nn], w)
        rms = jnp.sqrt(jnp.sum(w * dist**2) / jnp.maximum(jnp.sum(w), 1.0))
        return tf.apply(points), rms

    points = scan
    rms = np.inf
    for i in range(max_iter):
        key, sub = jax.random.split(key)
        points, rms_j = one_iter(points, sub)
        rms = float(rms_j)
        if rms < rms_threshold:
            break
    return np.asarray(points), rms, rms < rms_threshold
