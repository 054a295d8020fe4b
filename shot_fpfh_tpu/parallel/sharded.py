"""Multi-chip registration stages: shard_map over a 1-D device mesh.

The sharding layout (SURVEY.md §5, BASELINE.json north star):

- **Descriptors** — keypoint blocks are data-parallel: each device computes
  SHOT local RFs + histograms for its keypoint shard against the replicated
  support cloud.  No collectives in the hot loop.
- **Matching** — scan descriptors stay put; *ref-descriptor tiles ride a device
  ring* (``ppermute``), each device keeping a running top-2 against every ref
  tile — the ring-attention dataflow, so the full K_scan x K_ref distance
  matrix never exists in any one chip's device memory.
- **RANSAC** — draws are solved identically everywhere (tiny batched Kabsch);
  inlier counting is sharded over matches and ``psum``-reduced.
- **ICP** — scan points sharded; each iteration psums either the 6x6
  point-to-plane normal equations or the Kabsch sufficient statistics
  (22/42 floats per step cross the mesh, nothing else).

Everything here also runs on a CPU mesh (``--xla_force_host_platform_device_count``),
which is how the test suite and the driver's multichip dry-run exercise it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.solvers import (
    point_to_plane_normal_eq,
    point_to_point_stats,
    solve_point_to_plane_from_normal_eq,
    solve_point_to_point,
    solve_point_to_point_from_stats,
)
from ..core.transform import RigidTransform
from ..models.shot import local_reference_frames, shot_from_neighborhoods
from ..ops.neighbors import radius_search
from .mesh import POINTS_AXIS, host_array, pad_to_multiple, replicate, shard_rows


# ------------------------------------------------------------- descriptors --
def sharded_shot_descriptors(
    keypoints: np.ndarray,
    support: np.ndarray,
    normals: np.ndarray,
    radius: float,
    mesh: Mesh,
    *,
    k_max: int = 256,
    min_neighborhood_size: int = 100,
    normalize: bool = True,
    use_grid: bool | None = None,
    rf_radius: float | None = None,
    shared_rfs=None,
    return_rfs: bool = False,
):
    """SHOT descriptors with keypoints sharded over the mesh.

    Above ``AUTO_GRID_MIN_POINTS`` (or with ``use_grid=True``) the support
    cloud is bucketed once into a grid-hash engine whose arrays replicate
    across the mesh, so each device runs the compacted candidate scan on its
    keypoint shard — the multi-chip path scales to ~1M-point supports.

    Scale options (reference shot_parallelization.py:185-312 parity):
    ``rf_radius`` computes the local reference frames from a *different*
    neighborhood radius (bi-scale); ``shared_rfs`` reuses frames from a
    previous call — pass the array returned by ``return_rfs=True``, which
    stays row-sharded on the mesh so no cross-device traffic occurs when
    chaining scales over the same keypoints."""
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    n_dev = mesh.devices.size
    kp_padded, n_orig = pad_to_multiple(np.asarray(keypoints, np.float32), n_dev)
    kp = shard_rows(kp_padded, mesh)
    if use_grid is None:
        use_grid = len(support) >= AUTO_GRID_MIN_POINTS

    rfs_in = None
    if shared_rfs is not None:
        if isinstance(shared_rfs, jax.Array) and len(shared_rfs) == len(kp_padded):
            rfs_in = shared_rfs  # already the sharded array from a prior call
        else:
            rfs_pad, _ = pad_to_multiple(np.asarray(shared_rfs, np.float32), n_dev)
            rfs_in = shard_rows(rfs_pad, mesh)

    def body(kp_block, rfs_block, search):
        nbr, vals = search(kp_block, radius)
        if rfs_block is not None:
            rfs = rfs_block
        elif rf_radius is not None:
            rf_nbr, rf_vals = search(kp_block, rf_radius)
            rfs = local_reference_frames(
                kp_block, rf_vals[..., :3], rf_nbr.mask, rf_radius
            )
        else:
            rfs = local_reference_frames(kp_block, vals[..., :3], nbr.mask, radius)
        desc = shot_from_neighborhoods(
            kp_block, vals[..., :3], vals[..., 3:6], nbr.mask, rfs, radius,
            normalize=normalize, min_neighborhood_size=min_neighborhood_size,
        )
        return desc, rfs

    rf_spec = P(POINTS_AXIS, None, None)
    if use_grid:
        from ..models.shot import shot_from_window_ff
        from ..ops.grid_hash import window_distances

        max_r = float(radius) if rf_radius is None else float(max(radius, rf_radius))
        grid = build_grid(np.asarray(support, np.float32), max_r / 2,
                          extras=np.asarray(normals, np.float32), halo=2)
        grid = jax.tree_util.tree_map(lambda x: replicate(np.asarray(x), mesh), grid)
        grid_specs = jax.tree_util.tree_map(lambda _: P(), grid)

        def window_body(kp_block, rfs_block, grid_rep):
            # grouped feature-planar window fetch + no-top-k SHOT — the same
            # exact-uncapped formulation as the single-device grid path
            vals, d, win_ok, _rows = window_distances(grid_rep, kp_block)
            rf_dist_inf = None
            if rfs_block is None and rf_radius is not None:
                # bi-scale: frames from the rf_radius validity plane of the
                # same window (resolved inside shot_from_window_ff)
                rf_dist_inf = jnp.where(win_ok & (d <= rf_radius), d, jnp.inf)
            dist_inf = jnp.where(win_ok & (d <= radius), d, jnp.inf)
            return shot_from_window_ff(
                kp_block, vals, dist_inf, radius,
                normalize=normalize,
                min_neighborhood_size=min_neighborhood_size,
                local_rfs=rfs_block, rf_dist_inf=rf_dist_inf,
                rf_radius=rf_radius if rf_dist_inf is not None else None,
            )

        if rfs_in is None:
            @jax.jit
            @functools.partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(POINTS_AXIS, None), grid_specs),
                out_specs=(P(POINTS_AXIS, None), rf_spec),
            )
            def compute_grid(kp_block, grid_rep):
                return window_body(kp_block, None, grid_rep)

            desc, rfs_out = compute_grid(kp, grid)
        else:
            @jax.jit
            @functools.partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(POINTS_AXIS, None), rf_spec, grid_specs),
                out_specs=(P(POINTS_AXIS, None), rf_spec),
            )
            def compute_grid_rfs(kp_block, rfs_block, grid_rep):
                return window_body(kp_block, rfs_block, grid_rep)

            desc, rfs_out = compute_grid_rfs(kp, rfs_in, grid)
    else:
        sup = replicate(np.asarray(support, np.float32), mesh)
        nrm = replicate(np.asarray(normals, np.float32), mesh)

        def brute_search(sup_rep, nrm_rep):
            def search(q, r):
                nbr = radius_search(q, sup_rep, r, k_max)
                vals = jnp.concatenate(
                    [sup_rep[nbr.idx], nrm_rep[nbr.idx]], axis=-1
                )
                return nbr, vals
            return search

        if rfs_in is None:
            @jax.jit
            @functools.partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(POINTS_AXIS, None), P(), P()),
                out_specs=(P(POINTS_AXIS, None), rf_spec),
            )
            def compute(kp_block, sup_rep, nrm_rep):
                return body(kp_block, None, brute_search(sup_rep, nrm_rep))

            desc, rfs_out = compute(kp, sup, nrm)
        else:
            @jax.jit
            @functools.partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(POINTS_AXIS, None), rf_spec, P(), P()),
                out_specs=(P(POINTS_AXIS, None), rf_spec),
            )
            def compute_rfs(kp_block, rfs_block, sup_rep, nrm_rep):
                return body(kp_block, rfs_block, brute_search(sup_rep, nrm_rep))

            desc, rfs_out = compute_rfs(kp, rfs_in, sup, nrm)

    desc_np = host_array(desc)[:n_orig]
    if return_rfs:
        return desc_np, rfs_out  # rfs stay sharded for reuse across scales
    return desc_np


# ---------------------------------------------------------------- normals ---
def sharded_normals(
    query_points: np.ndarray,
    cloud_points: np.ndarray,
    mesh: Mesh,
    *,
    k: int | None = None,
    radius: float | None = None,
    pre_computed_normals=None,
    k_max: int = 64,
    sample_size: int = 512,
) -> np.ndarray:
    """PCA normals with queries sharded over the mesh (multi-chip counterpart
    of ``models.normals.compute_normals``; reference
    pca_based_descriptors.py:29-59).

    Large clouds replicate the grid engine across devices and each device
    scans its query shard.  The k-NN flavor bounds the k-th-neighbor distance
    from a host-side sample (like ``ops.grid_hash.knn_auto``) and keeps the
    same exactness net: queries whose k-th neighbor fell outside the bound
    (sparse regions — typically a fraction of a percent) are re-solved with a
    single-device brute-force pass after the sharded program returns."""
    from ..ops.eigh3 import pca_eigh
    from ..ops.grid_hash import (
        AUTO_GRID_MIN_POINTS,
        build_grid,
        _grid_radius_pca_jit,
    )
    from ..ops.neighbors import knn

    assert k is not None or radius is not None, "Provide k or radius."
    n_dev = mesh.devices.size
    q_pad, n_orig = pad_to_multiple(np.asarray(query_points, np.float32), n_dev)
    q = shard_rows(q_pad, mesh)
    pre_in = None
    if pre_computed_normals is not None:
        pre_pad, _ = pad_to_multiple(
            np.asarray(pre_computed_normals, np.float32), n_dev
        )
        pre_in = shard_rows(pre_pad, mesh)

    cloud = np.asarray(cloud_points, np.float32)
    large = len(cloud) >= AUTO_GRID_MIN_POINTS

    def finish(normals, pre_block):
        if pre_block is not None:
            flip = jnp.sum(normals * pre_block, axis=-1) < 0
            normals = jnp.where(flip[..., None], -normals, normals)
        return normals

    radii_in = None
    if k is not None:
        if large:
            # streaming covariance with adaptive per-query radii (same
            # k-targeting route + documented deviation as the single-device
            # models.normals._streaming_knn_normals; VERDICT r3 #3) — the
            # top-k selection inside grid_radius_search dominated sharded
            # 1M-point normals the same way it did single-device
            from ..models.normals import _knn_target_radii
            from ..ops.grid_hash import (
                kth_distance_bound,
                quantized_kth_radius,
                _grid_radius_pca_jit,
            )

            stride = max(1, len(cloud) // sample_size)
            sample = cloud[::stride][:sample_size]
            kth = np.asarray(kth_distance_bound(
                jnp.asarray(sample), jnp.asarray(cloud), k
            ))
            search_r = quantized_kth_radius(kth)
            grid_host = build_grid(cloud, search_r, extras=None, halo=1)
            r_q = np.asarray(_knn_target_radii(
                grid_host, jnp.asarray(q_pad), k, sample, kth
            ), np.float32)
            radii_in = shard_rows(r_q[:, None], mesh)
            grid = jax.tree_util.tree_map(
                lambda x: replicate(np.asarray(x), mesh), grid_host
            )
            grid_specs = jax.tree_util.tree_map(lambda _: P(), grid)

            def kernel(q_block, pre_block, grid_rep, r_block):
                from ..ops.eigh3 import eigh3x3

                cov, _, count = _grid_radius_pca_jit(
                    grid_rep, q_block, r_block[:, 0]
                )
                _, v = eigh3x3(cov)
                return finish(v[..., :, 0], pre_block), count
        else:
            cloud_rep = replicate(cloud, mesh)

            def kernel(q_block, pre_block, cloud_r, _r):
                nbr = knn(q_block, cloud_r, k)
                _, v, _ = pca_eigh(cloud_r[nbr.idx], nbr.mask)
                return finish(v[..., :, 0], pre_block), jnp.sum(nbr.mask, axis=-1)
    else:
        if large:
            grid = build_grid(cloud, float(radius), extras=None, halo=1)
            grid = jax.tree_util.tree_map(
                lambda x: replicate(np.asarray(x), mesh), grid
            )
            grid_specs = jax.tree_util.tree_map(lambda _: P(), grid)

            def kernel(q_block, pre_block, grid_rep, _r):
                from ..ops.eigh3 import eigh3x3

                cov, _, _ = _grid_radius_pca_jit(grid_rep, q_block, radius)
                _, v = eigh3x3(cov)
                return finish(v[..., :, 0], pre_block)
        else:
            cloud_rep = replicate(cloud, mesh)

            def kernel(q_block, pre_block, cloud_r, _r):
                nbr = radius_search(q_block, cloud_r, radius, k_max)
                _, v, _ = pca_eigh(cloud_r[nbr.idx], nbr.mask)
                return finish(v[..., :, 0], pre_block)

    rep_arg = grid if large else cloud_rep
    rep_spec = grid_specs if large else P()
    pre_spec = P(POINTS_AXIS, None) if pre_in is not None else P()
    pre_arg = pre_in if pre_in is not None else replicate(
        np.zeros((1, 3), np.float32), mesh
    )
    radii_spec = P(POINTS_AXIS, None) if radii_in is not None else P()
    radii_arg = radii_in if radii_in is not None else replicate(
        np.zeros((1, 1), np.float32), mesh
    )
    out_specs = (
        (P(POINTS_AXIS, None), P(POINTS_AXIS)) if k is not None
        else P(POINTS_AXIS, None)
    )

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(POINTS_AXIS, None), pre_spec, rep_spec, radii_spec),
        out_specs=out_specs,
    )
    def run(q_block, pre_block, rep, r_block):
        return kernel(q_block, pre_block if pre_in is not None else None,
                      rep, r_block)

    out = run(q, pre_arg, rep_arg, radii_arg)
    if k is None:
        return host_array(out)[:n_orig]
    normals, count = out
    normals = np.array(host_array(normals)[:n_orig])  # writable copy for the net
    # exactness net (one host sync): re-solve under-covered queries exactly
    missing = host_array(count)[:n_orig] < min(k, len(cloud))
    if missing.any():
        from ..ops.eigh3 import pca_eigh as _pca
        from ..ops.grid_hash import pad_pow2_bucket
        from ..ops.neighbors import knn as _knn

        miss = np.nonzero(missing)[0]
        miss_pad = pad_pow2_bucket(miss)
        qj = jnp.asarray(np.asarray(query_points, np.float32)[miss_pad])
        cj = jnp.asarray(cloud)
        nbr = _knn(qj, cj, k)
        _, v, _ = _pca(cj[nbr.idx], nbr.mask)
        fixed = v[..., :, 0]
        if pre_computed_normals is not None:
            pre_m = jnp.asarray(
                np.asarray(pre_computed_normals, np.float32)[miss_pad]
            )
            flip = jnp.sum(fixed * pre_m, axis=-1) < 0
            fixed = jnp.where(flip[..., None], -fixed, fixed)
        normals[miss] = np.asarray(fixed)[:len(miss)]
    return normals


# ------------------------------------------------------------------ FPFH ----
def sharded_fpfh(
    keypoint_indices: np.ndarray,
    cloud_points: np.ndarray,
    normals: np.ndarray,
    radius: float,
    mesh: Mesh,
    *,
    n_bins: int = 5,
    k_max: int = 128,
    decorrelated: bool = False,
) -> np.ndarray:
    """FPFH with both passes sharded over the mesh (multi-chip counterpart of
    ``models.fpfh.compute_fpfh_descriptor``; reference descriptors/fpfh.py:16-117).

    Pass 1 (SPFH — the most expensive stage at 1M scale, VERDICT r1 missing
    #3): every cloud point is a query; the query axis shards, the grid engine
    replicates, the (N, D) SPFH table comes out row-sharded.  Pass 2
    re-gathers the SPFH table replicated (one all-gather of N·D floats — the
    only cross-device traffic) and each device aggregates its keypoint shard
    through a second grid search, which reproduces pass 1's neighborhoods
    exactly (same grid, same radius, same cap)."""
    from jax.sharding import NamedSharding
    from ..models.fpfh import _spfh_from_values
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    n_dev = mesh.devices.size
    cloud = np.asarray(cloud_points, np.float32)
    nrm = np.asarray(normals, np.float32)
    n = len(cloud)

    # pad queries with a far-away sentinel so padded rows see empty
    # neighborhoods instead of aliasing the origin
    c_pad, _ = pad_to_multiple(cloud, n_dev)
    nrm_pad, _ = pad_to_multiple(nrm, n_dev)
    if len(c_pad) > n:
        c_pad = c_pad.copy()
        c_pad[n:] = 1.0e6
    q = shard_rows(c_pad, mesh)
    qn = shard_rows(nrm_pad, mesh)

    use_grid = n >= AUTO_GRID_MIN_POINTS
    if use_grid:
        # grid-window formulation (matches the single-device large-cloud
        # path): SPFH computed over EXACT uncapped windows in grid-sorted
        # order, sharded by row index; the aggregation re-gathers neighbor
        # SPFH with the same grouped window indices
        from ..models.fpfh import _fpfh_window_agg_block, _spfh_window_block

        grid = build_grid(cloud, float(radius) / 2, extras=nrm, halo=2)
        orig_idx_np = np.asarray(grid.orig_idx)
        grid = jax.tree_util.tree_map(lambda x: replicate(np.asarray(x), mesh), grid)
        grid_specs = jax.tree_util.tree_map(lambda _: P(), grid)

        chunk = 4096
        per_dev = -(-n // (n_dev * chunk)) * chunk
        n_pad = per_dev * n_dev
        idx_sh = shard_rows(np.arange(n_pad, dtype=np.int32), mesh)

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(POINTS_AXIS), grid_specs),
            out_specs=P(POINTS_AXIS, None),
        )
        def pass1(idx_blk, grid_rep):
            def one(ib):
                safe = jnp.minimum(ib, n - 1)
                rowvals = grid_rep.packed_sorted[safe]
                qc = jnp.where((ib < n)[:, None], rowvals[:, :3], 1.0e6)
                return _spfh_window_block(
                    grid_rep, qc, rowvals[:, 3:6], radius, n_bins, decorrelated
                )

            m = idx_blk.shape[0] // chunk
            out = jax.lax.map(one, idx_blk.reshape(m, chunk))
            return out.reshape(idx_blk.shape[0], -1)

        spfh_sharded = pass1(idx_sh, grid)
        # the one collective: replicate the SPFH table for pass-2 gathers (a
        # jitted identity with replicated out_shardings works across
        # processes, unlike host-side device_put resharding)
        spfh_rep = jax.jit(
            lambda x: x, out_shardings=NamedSharding(mesh, P())
        )(spfh_sharded)

        inv = np.empty(n, np.int32)
        inv[orig_idx_np] = np.arange(n, dtype=np.int32)
        kp_sorted = inv[np.asarray(keypoint_indices, np.int32).reshape(-1)]
        kp_pad, n_kp = pad_to_multiple(kp_sorted, n_dev)
        kp_sh = shard_rows(kp_pad, mesh)
        group = 8
        ng = -(-n // group)

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(POINTS_AXIS), P(), grid_specs),
            out_specs=P(POINTS_AXIS, None),
        )
        def pass2(kp_blk, spfh_r, grid_rep):
            spfh_g = spfh_r[:ng * group].reshape(ng, group * spfh_r.shape[1])
            return _fpfh_window_agg_block(
                grid_rep, spfh_r, spfh_g, kp_blk, radius, group
            )

        out = pass2(kp_sh, spfh_rep, grid)
        return host_array(out)[:n_kp]

    packed = np.concatenate([cloud, nrm], axis=1)
    packed_rep = replicate(packed, mesh)

    def search(packed_r, qb):
        nbr = radius_search(qb, packed_r[:, :3], radius, k_max)
        vals = jnp.where(nbr.mask[..., None], packed_r[nbr.idx], 0.0)
        return nbr, vals

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(POINTS_AXIS, None), P(POINTS_AXIS, None), P()),
        out_specs=P(POINTS_AXIS, None),
    )
    def pass1(q_block, qn_block, rep):
        nbr, vals = search(rep, q_block)
        return _spfh_from_values(
            q_block, qn_block, vals[..., :3], vals[..., 3:6], nbr.dist,
            nbr.mask, radius, n_bins, decorrelated,
        )

    spfh_sharded = pass1(q, qn, packed_rep)
    spfh_rep = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(spfh_sharded)

    kp_pad, n_kp = pad_to_multiple(
        np.asarray(keypoint_indices, np.int32).reshape(-1), n_dev
    )
    kp_sh = shard_rows(kp_pad, mesh)
    cloud_rep = replicate(cloud, mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(POINTS_AXIS), P(), P(), P()),
        out_specs=P(POINTS_AXIS, None),
    )
    def pass2(kp_block, spfh_r, cloud_r, rep):
        kp_pts = cloud_r[kp_block]
        nbr, _ = search(rep, kp_pts)
        d = nbr.dist
        m = nbr.mask & (d > 0)
        w = jnp.where(m, 1.0 / jnp.where(m, d, 1.0), 0.0)
        acc = jnp.einsum("ckd,ck->cd", spfh_r[nbr.idx], w)
        count = jnp.maximum(jnp.sum(nbr.mask, axis=-1), 1).astype(jnp.float32)
        return spfh_r[kp_block] + acc / count[:, None]

    out = pass2(kp_sh, spfh_rep, cloud_rep, packed_rep)
    return host_array(out)[:n_kp]


# ------------------------------------------------------------ ring matching --
class RingMatchResult(NamedTuple):
    idx: np.ndarray   # (Qs,) global index of nearest ref descriptor
    d1: np.ndarray    # (Qs,) nearest distance
    d2: np.ndarray    # (Qs,) second-nearest distance


def ring_match(
    scan_descriptors: np.ndarray, ref_descriptors: np.ndarray, mesh: Mesh
) -> RingMatchResult:
    """Nearest + second-nearest ref descriptor per scan descriptor, with ref
    tiles passed around the ring via ``ppermute`` — no chip ever holds more
    than its own ref tile."""
    n_dev = mesh.devices.size
    a_padded, n_scan = pad_to_multiple(np.asarray(scan_descriptors, np.float32), n_dev)
    b_np = np.asarray(ref_descriptors, np.float32)
    b_padded, n_ref = pad_to_multiple(b_np, max(2 * n_dev, n_dev))
    b_valid = np.arange(len(b_padded)) < n_ref

    a = shard_rows(a_padded, mesh)
    b = shard_rows(b_padded, mesh)
    bv = shard_rows(b_valid, mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(POINTS_AXIS, None), P(POINTS_AXIS, None), P(POINTS_AXIS)),
        out_specs=(P(POINTS_AXIS), P(POINTS_AXIS), P(POINTS_AXIS)),
    )
    def inner(a_blk, b_blk, bv_blk):
        # same compute-dtype convention as the single-device matcher
        # (registration.matching._top_scan): bf16 operands / f32 accumulation,
        # norms computed FROM the rounded values — so the mesh and
        # single-device paths see identical quantization (and the ref tiles
        # ride the ring at half the bytes)
        a_blk = a_blk.astype(jnp.bfloat16)
        b_blk = b_blk.astype(jnp.bfloat16)
        qb = b_blk.shape[0]
        me = jax.lax.axis_index(POINTS_AXIS)
        perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
        an = jnp.sum(a_blk.astype(jnp.float32) ** 2, axis=-1, keepdims=True)

        def step(carry, i):
            b_cur, bv_cur, best_d, best_i, second_d = carry
            src = (me - i) % n_dev  # origin shard of the tile we hold now
            bn = jnp.sum(b_cur.astype(jnp.float32) ** 2, axis=-1)[None, :]
            prod = jax.lax.dot_general(
                a_blk, b_cur, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
            d2m = jnp.maximum(an + bn - 2.0 * prod, 0.0)
            d2m = jnp.where(bv_cur[None, :], d2m, jnp.inf)
            from ..registration.matching import top2_rows

            i1, d1_sq, d2_sq = top2_rows(d2m)
            d1_blk = jnp.sqrt(jnp.maximum(d1_sq, 0.0))   # inf rows stay inf
            d2_blk = jnp.sqrt(jnp.maximum(d2_sq, 0.0))
            gi = (src * qb + i1).astype(jnp.int32)

            better = d1_blk < best_d
            new_second = jnp.minimum(
                jnp.minimum(jnp.maximum(best_d, d1_blk), second_d), d2_blk
            )
            new_best = jnp.where(better, d1_blk, best_d)
            new_best_i = jnp.where(better, gi, best_i)

            b_next = jax.lax.ppermute(b_cur, POINTS_AXIS, perm)
            bv_next = jax.lax.ppermute(bv_cur, POINTS_AXIS, perm)
            return (b_next, bv_next, new_best, new_best_i, new_second), None

        qa = a_blk.shape[0]
        vary = lambda x: jax.lax.pcast(x, POINTS_AXIS, to="varying")  # noqa: E731
        init = (
            b_blk, bv_blk,
            vary(jnp.full((qa,), jnp.inf, jnp.float32)),
            vary(jnp.zeros((qa,), jnp.int32)),
            vary(jnp.full((qa,), jnp.inf, jnp.float32)),
        )
        (b_fin, bv_fin, best_d, best_i, second_d), _ = jax.lax.scan(
            step, init, jnp.arange(n_dev)
        )
        return best_i, best_d, second_d

    idx, d1, d2 = inner(a, b, bv)
    return RingMatchResult(
        host_array(idx)[:n_scan], host_array(d1)[:n_scan], host_array(d2)[:n_scan]
    )


def sharded_multiscale_match(
    scan_ms: np.ndarray,
    ref_ms: np.ndarray,
    mesh: Mesh,
    *,
    filter_nonreciprocal: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Multiscale ("infinite-norm") matching with scan rows sharded over the
    mesh (multi-chip route of ``registration.matching.match_descriptors``'s
    multiscale branch; reference matching/matching.py:77-136).

    Each device runs the chunked running-min-over-scales matcher on its scan
    shard against the replicated ref stack; the per-scale reciprocal column
    argmin is combined across shards with one ``all_gather`` of ``(R,)``
    min/argmin pairs per scale — tie-breaking by lowest global row index, so
    the result is bit-identical to the single-device ``multiscale_top1``.

    Returns ``(idx (Q,), dist (Q,))`` on the host."""
    from jax.sharding import NamedSharding
    from ..registration.matching import _ms_combined_top1, _ms_scale_pass

    n_dev = mesh.devices.size
    n_scales, n_points, dim = scan_ms.shape
    per_dev = -(-n_points // n_dev)
    q_pad = per_dev * n_dev
    a_np = np.zeros((n_scales, q_pad, dim), np.float32)
    a_np[:, :n_points] = np.asarray(scan_ms, np.float32)  # pad rows are all-
    a = jax.device_put(                                   # zero, hence invalid
        a_np, NamedSharding(mesh, P(None, POINTS_AXIS, None))
    )
    b = replicate(np.asarray(ref_ms, np.float32), mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, POINTS_AXIS, None), P()),
        out_specs=(P(POINTS_AXIS), P(POINTS_AXIS)),
    )
    def inner(a_blk, b_rep):
        vary = lambda x: jax.lax.pcast(x, POINTS_AXIS, to="varying")  # noqa: E731
        row_base = jax.lax.axis_index(POINTS_AXIS) * per_dev
        s_ok = jnp.any(a_blk != 0, axis=2)
        r_ok = jnp.any(b_rep != 0, axis=2)
        row_ok = s_ok
        if filter_nonreciprocal:
            def recip_scale(xs):
                a_s, ok_s, b_s, bok_s = xs
                row_i, col_d, col_i = _ms_scale_pass(
                    a_s, b_s, ok_s, bok_s, row_base=row_base, vary=vary
                )
                all_d = jax.lax.all_gather(col_d, POINTS_AXIS)  # (n_dev, R)
                all_i = jax.lax.all_gather(col_i, POINTS_AXIS)
                dev = jnp.argmin(all_d, axis=0)  # ties: lowest global row
                g_col_i = jnp.take_along_axis(all_i, dev[None, :], axis=0)[0]
                local_rows = row_base + jnp.arange(a_s.shape[0], dtype=jnp.int32)
                return g_col_i[row_i] == local_rows

            recip = jax.lax.map(recip_scale, (a_blk, s_ok, b_rep, r_ok))
            row_ok = s_ok & recip
        return _ms_combined_top1(a_blk, b_rep, row_ok, r_ok, vary=vary)

    idx, dist = inner(a, b)
    return host_array(idx)[:n_points], host_array(dist)[:n_points]


# ----------------------------------------------------------------- RANSAC ---
def sharded_ransac(
    scan_matched: np.ndarray,
    ref_matched: np.ndarray,
    key,
    mesh: Mesh,
    *,
    n_draws: int = 10000,
    draw_size: int = 4,
    distance_threshold: float = 1.0,
    draw_chunk: int = 256,
) -> tuple[float, RigidTransform]:
    """RANSAC with inlier counting sharded over matches and psum-reduced.

    The candidate transforms are solved identically on every device (tiny
    batched Kabsch on replicated draws); only the (n_draws x local_matches)
    inlier counting fans out.
    """
    n_dev = mesh.devices.size
    m = len(scan_matched)
    s_pad, _ = pad_to_multiple(np.asarray(scan_matched, np.float32), n_dev)
    r_pad, _ = pad_to_multiple(np.asarray(ref_matched, np.float32), n_dev)
    valid = np.arange(len(s_pad)) < m

    s_rep = replicate(np.asarray(scan_matched, np.float32), mesh)
    r_rep = replicate(np.asarray(ref_matched, np.float32), mesh)
    s_sh = shard_rows(s_pad, mesh)
    r_sh = shard_rows(r_pad, mesh)
    v_sh = shard_rows(valid, mesh)
    key_rep = replicate(jax.random.key_data(key), mesh)

    n_chunks = -(-n_draws // draw_chunk)
    thr2 = np.float32(distance_threshold**2)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(POINTS_AXIS, None), P(POINTS_AXIS, None), P(POINTS_AXIS), P()),
        out_specs=(P(), P(), P()),
    )
    def inner(scan_rep, ref_rep, scan_blk, ref_blk, valid_blk, key_data):
        k = jax.random.wrap_key_data(key_data)
        keys = jax.random.split(k, n_chunks * draw_chunk)
        draws = jax.vmap(
            lambda kk: jax.random.choice(kk, m, shape=(draw_size,), replace=False)
        )(keys).reshape(n_chunks, draw_chunk, draw_size)
        valid_f = valid_blk.astype(jnp.float32)

        def step(carry, draw_idx):
            best_count, best_rot, best_t = carry
            src = scan_rep[draw_idx]
            dst = ref_rep[draw_idx]
            tf = solve_point_to_point(src, dst)
            moved = (
                jnp.einsum("cij,mj->cmi", tf.rotation, scan_blk)
                + tf.translation[:, None, :]
            )
            d2 = jnp.sum((moved - ref_blk[None]) ** 2, axis=-1)
            local = jnp.sum((d2 <= thr2).astype(jnp.float32) * valid_f[None, :], axis=-1)
            counts = jax.lax.psum(local, POINTS_AXIS)  # identical on all devices
            i = jnp.argmax(counts)
            better = counts[i] > best_count
            return (
                jnp.where(better, counts[i], best_count),
                jnp.where(better, tf.rotation[i], best_rot),
                jnp.where(better, tf.translation[i], best_t),
            ), None

        init = (jnp.float32(-1.0), jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        (count, rot, t), _ = jax.lax.scan(step, init, draws)
        return count, rot, t

    count, rot, t = inner(s_rep, r_rep, s_sh, r_sh, v_sh, key_rep)
    best = RigidTransform(rot, t).normalize_rotation()
    return float(count) / m, best


# -------------------------------------------------------------------- ICP ---
def sharded_icp(
    scan_sub: np.ndarray,
    ref: np.ndarray,
    ref_normals: np.ndarray | None,
    init: RigidTransform,
    mesh: Mesh,
    *,
    d_max: float,
    max_iter: int = 50,
    rms_threshold: float = 1e-3,
    point_to_plane: bool = True,
) -> tuple[RigidTransform, float, bool, int]:
    """ICP with the subsampled scan sharded over the mesh; per-iteration
    reductions are psums of the solver's sufficient statistics.

    Large refs (``AUTO_GRID_MIN_POINTS``, same threshold as the single-device
    path at registration/icp.py:106-111) bucket once into a grid-hash engine
    whose arrays replicate across the mesh — exactly as ``sharded_fpfh``
    replicates its grid — so each iteration's 1-NN is a per-shard window scan
    instead of an O(shard x N_ref) matmul against the whole replicated cloud
    (VERDICT r2 weak #3).  ``cell_size == d_max`` keeps it exact: any true
    nearest neighbor beyond the scanned window is past the inlier cut."""
    from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid

    n_dev = mesh.devices.size
    s_pad, n_orig = pad_to_multiple(np.asarray(scan_sub, np.float32), n_dev)
    valid = np.arange(len(s_pad)) < n_orig

    s_sh = shard_rows(s_pad, mesh)
    v_sh = shard_rows(valid, mesh)
    ref_np = np.asarray(ref, np.float32)
    ref_rep = replicate(ref_np, mesh)
    nrm_rep = replicate(
        np.asarray(ref_normals if ref_normals is not None else ref, np.float32), mesh
    )
    init_rot = replicate(np.asarray(init.rotation, np.float32), mesh)
    init_t = replicate(np.asarray(init.translation, np.float32), mesh)

    use_grid = len(ref_np) >= AUTO_GRID_MIN_POINTS
    if use_grid:
        grid = build_grid(ref_np, float(d_max))
        grid = jax.tree_util.tree_map(lambda x: replicate(np.asarray(x), mesh), grid)
        grid_spec = jax.tree_util.tree_map(lambda _: P(), grid)
    else:
        grid, grid_spec = replicate(np.zeros((1,), np.float32), mesh), P()

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(POINTS_AXIS, None), P(POINTS_AXIS), P(), P(), P(), P(),
                  grid_spec),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def run(scan_blk, valid_blk, ref_r, nrm_r, rot0, t0, grid_r):
        from ..ops.neighbors import _sq_dists  # local tile argmin, no jit wrapper

        def nn(q):
            if use_grid:
                from ..ops.grid_hash import grid_nearest_neighbor

                return grid_nearest_neighbor(grid_r, q)
            d2 = _sq_dists(q, ref_r)
            idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
            return jnp.linalg.norm(q - ref_r[idx], axis=-1), idx

        def body(state):
            i, rot, t, _rms, _done = state
            moved = scan_blk @ rot.T + t
            dist, idx = nn(moved)
            w = ((dist <= d_max) & valid_blk).astype(jnp.float32)
            target = ref_r[idx]
            if point_to_plane:
                gtg, gth = point_to_plane_normal_eq(moved, target, nrm_r[idx], w)
                gtg = jax.lax.psum(gtg, POINTS_AXIS)
                gth = jax.lax.psum(gth, POINTS_AXIS)
                delta = solve_point_to_plane_from_normal_eq(gtg, gth)
                res = jnp.abs(jnp.sum((moved - target) * nrm_r[idx], axis=-1))
                num = jax.lax.psum(jnp.sum(res * w), POINTS_AXIS)
                den = jax.lax.psum(jnp.sum(w), POINTS_AXIS)
                rms = num / jnp.maximum(den, 1.0)
            else:
                stats = point_to_point_stats(moved, target, w)
                stats = jax.tree_util.tree_map(
                    lambda x: jax.lax.psum(x, POINTS_AXIS), stats
                )
                delta = solve_point_to_point_from_stats(*stats)
                # grid 1-NN reports inf for window-miss queries; their w is 0
                # but 0 * inf**2 would still poison the RMS with NaN
                dist = jnp.where(w > 0, dist, 0.0)
                num = jax.lax.psum(jnp.sum(w * dist**2), POINTS_AXIS)
                den = jax.lax.psum(jnp.sum(w), POINTS_AXIS)
                rms = jnp.sqrt(num / jnp.maximum(den, 1.0))
            composed = RigidTransform(delta.rotation, delta.translation) @ RigidTransform(rot, t)
            return i + 1, composed.rotation, composed.translation, rms, rms < rms_threshold

        def cond(state):
            i, *_rest, done = state
            return (i < max_iter) & (~done)

        state = (
            jnp.asarray(0, jnp.int32), rot0, t0,
            jnp.asarray(jnp.inf, jnp.float32), jnp.asarray(False),
        )
        i, rot, t, rms, done = jax.lax.while_loop(cond, body, state)
        return rot, t, rms, done, i

    rot, t, rms, done, i = run(
        s_sh, v_sh, ref_rep, nrm_rep, init_rot, init_t, grid
    )
    return RigidTransform(rot, t), float(rms), bool(done), int(i)
