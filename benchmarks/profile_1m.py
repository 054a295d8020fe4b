"""Decompose the 1M-point at-scale stages:

1. grid build (cold, 1M, halo=2 + normals extras): device sort / ids d2h /
   host searchsorted / host cap passes / device cell_starts / extras packing
2. FPFH 1M: SPFH window pass vs keypoint aggregation
3. ICP 1M: per-iteration 1-NN vs solve (via iteration-count scaling)

Run on the GPU: python benchmarks/profile_1m.py
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp


def log(msg):
    import sys
    print(msg, file=sys.stderr, flush=True)


def force(x):
    return jax.block_until_ready(x)


def t(name, fn, reps=1):
    fn()  # warm (compile)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    log(f"  {name}: {best:.3f}s")
    return best


def main():
    from shot_fpfh_tpu.utils.perf import enable_compilation_cache
    enable_compilation_cache()
    log(f"devices: {jax.devices()}")
    float(jnp.zeros(()).sum())

    rng = np.random.default_rng(0)
    n1m = 1_000_000
    radius = 0.6
    xy = rng.uniform(-20, 20, size=(n1m, 2)).astype(np.float32)
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5))
    big = np.column_stack([xy, z]).astype(np.float32)
    dzdx = (0.8 * 0.9 * np.cos(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
            + 0.4 * 2.1 * np.cos(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5))
    dzdy = (-0.8 * 0.7 * np.sin(0.9 * xy[:, 0]) * np.sin(0.7 * xy[:, 1])
            - 0.4 * 1.7 * np.sin(2.1 * xy[:, 0] + 1.0) * np.sin(1.7 * xy[:, 1] + 0.5))
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n1m, np.float32)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)

    # ------------------------------------------------- grid build breakdown --
    from shot_fpfh_tpu.ops import grid_hash as gh

    cell = radius / 2
    halo = 2
    log("grid build breakdown (1M, cell=r/2, halo=2, extras=normals):")

    big_j = jnp.asarray(big)      # keep uploads out of stage timings first
    nrm_j = jnp.asarray(nrm)
    force((big_j, nrm_j))

    t0 = time.perf_counter()
    big_j2 = force(jnp.asarray(big + 1e-6))
    up = time.perf_counter() - t0
    log(f"  h2d upload of the 12MB cloud: {up:.3f}s")

    out = {}
    def dev_build():
        out["r"] = force(gh._build_device(big_j, jnp.float32(cell)))
    t("device sort/ids (_build_device)", dev_build, reps=2)
    pts_sorted, orig_idx, ids_sorted, origin, dims, size, meta = out["r"]

    t0 = time.perf_counter()
    meta_np = np.asarray(meta)
    dims_np = meta_np[:3]
    d2h = time.perf_counter() - t0
    log(f"  meta d2h (dims+max_occ, one sync): {d2h:.3f}s")
    t0 = time.perf_counter()
    ids_np = np.asarray(ids_sorted)
    log(f"  ids d2h (4MB, no longer on the build path): {time.perf_counter()-t0:.3f}s")

    n_cells = int(dims_np[0]) * int(dims_np[1]) * int(dims_np[2])
    log(f"  dims {tuple(int(v) for v in dims_np)} -> {n_cells} cells")

    cs = {}
    def host_ss():
        cs["v"] = np.searchsorted(
            ids_np, np.arange(n_cells + 1, dtype=np.int64), side="left"
        ).astype(np.int32)
    t("host searchsorted (cell_starts)", host_ss, reps=2)
    cell_starts_np = cs["v"]

    t("host _window_caps", lambda: gh._window_caps(cell_starts_np, dims_np, n1m, halo), reps=2)
    t("host _group_cap G=8", lambda: gh._group_cap(cell_starts_np, dims_np, halo, 8), reps=2)
    t("host _group_cap G=16", lambda: gh._group_cap(cell_starts_np, dims_np, halo, 16), reps=2)
    t("host _xyrow_caps x3 (8/16/32)", lambda: [
        gh._xyrow_caps(cell_starts_np, dims_np, halo, g) for g in (8, 16, 32)
    ], reps=2)

    padded_len = 1 << int(np.ceil(np.log2(n_cells + 1)))
    t("device cell_starts (searchsorted)",
      lambda: force(gh._cell_starts_device(ids_sorted, padded_len)), reps=2)

    @jax.jit
    def pack(pts_sorted, extras, orig_idx):
        return jnp.concatenate([pts_sorted, extras[orig_idx]], axis=1)
    t("device extras gather+concat", lambda: force(pack(pts_sorted, nrm_j, orig_idx)), reps=2)

    gh.clear_grid_cache()
    t0 = time.perf_counter()
    grid = gh.build_grid(big, cell, extras=nrm, halo=halo)
    log(f"  TOTAL build_grid cold (incl. h2d): {time.perf_counter() - t0:.3f}s")

    # ------------------------------------------------------ FPFH 1M split ---
    from shot_fpfh_tpu.core.subsampling import grid_subsample
    from shot_fpfh_tpu.models.fpfh import (_fpfh_window_aggregate,
                                           _spfh_window_sorted)

    kp_idx = np.asarray(grid_subsample(big, 0.9))
    pad = -(-len(kp_idx) // 1024) * 1024 - len(kp_idx)
    kp_idx_pad = np.concatenate([kp_idx, np.zeros(pad, kp_idx.dtype)])
    log(f"FPFH 1M split ({len(kp_idx)} keypoints):")
    inv = np.empty(n1m, np.int32)
    inv[np.asarray(grid.orig_idx)] = np.arange(n1m, dtype=np.int32)
    kp_sorted = jnp.asarray(inv[kp_idx_pad.astype(np.int32)])
    sp = {}
    def spfh():
        sp["v"] = force(_spfh_window_sorted(grid, radius, 5, False))
    t("SPFH window pass (1M rows)", spfh, reps=2)
    t("FPFH aggregate (keypoints)",
      lambda: force(_fpfh_window_aggregate(grid, sp["v"], kp_sorted, radius)),
      reps=2)

    # ------------------------------------------------------- ICP 1M split ---
    from scipy.spatial.transform import Rotation
    from shot_fpfh_tpu.ops.grid_hash import build_grid, grid_nearest_neighbor
    from shot_fpfh_tpu.registration.icp import icp_point_to_plane
    from shot_fpfh_tpu.core.transform import RigidTransform

    R = Rotation.from_euler("xyz", [0.02, -0.01, 0.04]).as_matrix().astype(np.float32)
    tr = np.array([0.08, -0.05, 0.03], np.float32)
    scan = (big - tr) @ R
    d_max, voxel = 0.5, 0.5

    def run_icp(max_iter):
        return icp_point_to_plane(
            scan, big, nrm, RigidTransform.identity(), d_max=d_max,
            voxel_size=voxel, max_iter=max_iter, rms_threshold=1e-6)

    res = run_icp(30)
    log(f"ICP 1M split (converges in {res.n_iters} iters):")
    t_full = t("ICP full (warm)", lambda: run_icp(30), reps=2)
    t_one = t("ICP capped at 1 iter", lambda: run_icp(1), reps=2)
    n_it = int(res.n_iters)
    if n_it > 1:
        log(f"  per-iteration (from {n_it} iters): "
            f"{(t_full - t_one) / (n_it - 1):.3f}s; first-iter+overhead {t_one:.3f}s")

    # 1-NN alone on the ICP grid (sub cloud scale)
    sub_idx = np.asarray(grid_subsample(scan, voxel))
    sub = jnp.asarray(scan[sub_idx])
    icp_grid = build_grid(big, d_max)
    t(f"grid 1-NN alone ({len(sub_idx)} queries)",
      lambda: force(grid_nearest_neighbor(icp_grid, sub)), reps=2)


if __name__ == "__main__":
    main()
