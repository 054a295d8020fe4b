"""Headline benchmark: SHOT descriptor + matching throughput vs CPU baseline.

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": R}

Workload (BASELINE.json north star): descriptors on a synthetic terrain cloud
at reference-default op scale (352-D SHOT, min 100-neighborhood), plus
nearest-descriptor matching.  The baseline is the reference architecture
re-derived in NumPy (KDTree + per-keypoint loop + multiprocessing pool,
benchmarks/numpy_baseline.py), measured on a keypoint subset of the same
workload and extrapolated per-descriptor.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_terrain(
    n: int, rng: np.random.Generator, scale: float = 10.0, n_bumps: int = 40
) -> np.ndarray:
    """Synthetic terrain: Gaussian bumps on a plane.  ``n_bumps`` sets the
    feature density — scale it with the area so local geometry stays
    distinctive (featureless surfaces make descriptor matching degenerate)."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-scale, scale, size=(n_bumps, 2))
    heights = rng.uniform(-2.0, 2.0, size=n_bumps)
    widths = rng.uniform(0.5, 2.5, size=n_bumps) * (scale / 10.0) * (40 / n_bumps) ** 0.5
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w**2))
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return pts.astype(np.float32)


def main() -> None:
    # workload scale: trimmed for CI-sized runs via env vars
    n_support = int(os.environ.get("BENCH_N_SUPPORT", 50_000))
    n_keypoints = int(os.environ.get("BENCH_N_KEYPOINTS", 4096))
    n_baseline = int(os.environ.get("BENCH_N_BASELINE", 192))
    radius = float(os.environ.get("BENCH_RADIUS", 0.9))
    k_max = int(os.environ.get("BENCH_K_MAX", 256))
    # the reps run on device (one fori_loop), so the per-rep number is
    # sustained device throughput with no per-call dispatch in it
    reps = int(os.environ.get("BENCH_REPS", 100))

    import jax
    import jax.numpy as jnp

    from shot_fpfh_tpu.utils.perf import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    devices = jax.devices()
    log(f"devices: {devices} (compilation cache: {cache_dir})")

    rng = np.random.default_rng(0)
    cloud = make_terrain(n_support, rng)
    normals_np = rng.normal(size=(n_support, 3))
    normals_np /= np.linalg.norm(normals_np, axis=1, keepdims=True)
    normals_np = normals_np.astype(np.float32)
    kp_idx = rng.choice(n_support, n_keypoints, replace=False)
    keypoints = cloud[kp_idx]

    from shot_fpfh_tpu.models.shot import shot_from_window_ff
    from shot_fpfh_tpu.ops.grid_hash import build_grid, window_distances
    from shot_fpfh_tpu.registration.matching import nearest_descriptor

    # grid built once per cloud (the analog of the reference's one-time KDTree
    # construction, which its per-keypoint timings exclude too); normals ride
    # along as extras so the search returns gathered [points | normals] rows
    t0 = time.perf_counter()
    grid = build_grid(cloud, radius / 2, extras=normals_np, halo=2)
    grid_build_s = time.perf_counter() - t0
    log(f"grid build: {grid_build_s:.2f}s "
        f"(cell_cap={grid.cell_cap}, window_cap={grid.window_cap})")

    def shot_and_match(kp, sup, nrm):
        # full-window formulation: fetch the candidate window with the
        # grouped FEATURE-PLANAR gather (8 rows per index — the gather is
        # index-bound, so ~3x cheaper than row-gather) and run LRF +
        # histogram over it directly — no top-k, no k_max cap, so the
        # descriptors use the EXACT uncapped radius neighborhoods (the
        # 256-cap used to truncate 3000/4096 of these) and the selection
        # cost disappears
        vals, d, valid, _rows = window_distances(grid, kp)
        dist_inf = jnp.where(valid & (d <= radius), d, jnp.inf)
        desc, _rfs = shot_from_window_ff(
            kp, vals, dist_inf, radius,
            normalize=True, min_neighborhood_size=100,
        )
        # matching leg: nearest descriptor within the same set (self-match
        # workload; same FLOP shape as scan-vs-ref)
        idx, dist = nearest_descriptor(desc, desc, jnp.ones(desc.shape[0], bool))
        return desc, idx

    # Timing methodology: the rep loop runs ON DEVICE (fori_loop with a data
    # dependency between reps via the input perturbation) and a single
    # scalar checksum comes back at the end.
    @jax.jit
    def timed_loop(kp, sup, nrm):
        def body(i, acc):
            desc, idx = shot_and_match(kp + i * 1e-7, sup, nrm)
            return acc + jnp.sum(desc) + jnp.sum(idx).astype(jnp.float32)

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    kp_j = jnp.asarray(keypoints)
    sup_j = jnp.asarray(cloud)
    nrm_j = jnp.asarray(normals_np)

    log("compiling + warmup...")
    t0 = time.perf_counter()
    float(timed_loop(kp_j, sup_j, nrm_j))
    first_call_s = time.perf_counter() - t0
    cold_s = grid_build_s + first_call_s
    log(f"first call (compile+run): {first_call_s:.1f}s "
        f"-> cold start (grid + compile) {cold_s:.1f}s")

    # best of two timed calls (min-of-k is the robust estimator here)
    times = []
    for shift in (0.5, 0.25):
        t0 = time.perf_counter()
        float(timed_loop(kp_j + shift, sup_j, nrm_j))
        times.append(time.perf_counter() - t0)
    dev_time = min(times) / reps
    dev_desc_per_sec = n_keypoints / dev_time
    desc, _ = jax.jit(shot_and_match)(kp_j, sup_j, nrm_j)
    nonzero = float(np.any(np.asarray(desc), axis=1).mean())
    log(f"{devices[0].platform}: {dev_time:.3f}s/rep for {n_keypoints} "
        f"descriptors+matching ({dev_desc_per_sec:.0f}/s, "
        f"{nonzero*100:.0f}% valid)")

    # ----------------------------------------------------------- baseline ---
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.numpy_baseline import match_descriptors_cpu, shot_descriptors_cpu

    # Single-process measurement (forking a Pool under a live JAX client
    # deadlocks), then credit the baseline with PERFECT 8-way pool scaling —
    # the reference's n_procs=8 never achieves that, so the reported ratio is
    # conservative.
    sub = keypoints[:n_baseline]
    shot_times, match_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        base_desc = shot_descriptors_cpu(sub, cloud, normals_np, radius,
                                         min_neighborhood_size=100, n_procs=1)
        shot_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        match_descriptors_cpu(base_desc, base_desc)
        match_times.append(time.perf_counter() - t0)
    base_shot_time = min(shot_times) / 8.0
    # matching leg extrapolated: cdist on the full keypoint set
    base_match_time = min(match_times) * (n_keypoints / n_baseline) ** 2
    base_per_desc = base_shot_time / n_baseline + base_match_time / n_keypoints
    base_desc_per_sec = 1.0 / base_per_desc
    log(f"cpu baseline (1-proc/8 idealized): {base_shot_time:.2f}s for {n_baseline} "
        f"descriptors (+{base_match_time:.2f}s matching extrapolated) "
        f"-> {base_desc_per_sec:.0f}/s")

    result = {
        "metric": "shot_descriptors_per_sec",
        "value": round(dev_desc_per_sec, 1),
        "unit": "descriptors/s (SHOT-352 + NN matching, 50k cloud)",
        "vs_baseline": round(dev_desc_per_sec / base_desc_per_sec, 2),
        "cold_start_seconds": round(cold_s, 1),
        "warm_seconds_per_call": round(dev_time, 4),
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }

    # vs the ACTUAL reference, measured on this machine with its real
    # n_procs=8 pool on the same workload (benchmarks/measure_reference.py →
    # BASELINE_measured.json) — VERDICT r1 missing #4
    measured_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BASELINE_measured.json"
    )
    if os.path.exists(measured_path):
        with open(measured_path) as f:
            measured = json.load(f)
        ref_rate = measured["bench_workload"]["descriptors_per_sec"]
        result["vs_reference_measured"] = round(dev_desc_per_sec / ref_rate, 2)
        log(f"measured reference (real 8-proc pool): {ref_rate:.0f} desc/s "
            f"-> vs_reference_measured {result['vs_reference_measured']}x")

    # ------------------------------------------------------ at-scale (1M) ---
    # Exact-uncapped SHOT + FPFH on a 1M-point cloud, grid-backed 1M-point
    # ICP, and a 100k x 100k device-resident Lowe matching.  Warm
    # (second-call) times; cold compiles ride the persistent cache.
    # BENCH_AT_SCALE=0 skips for CI-sized runs.
    if int(os.environ.get("BENCH_AT_SCALE", "1")):
        result.update(_at_scale_measurements(rng, log))
    print(json.dumps(result), flush=True)
    return


def _at_scale_measurements(rng, log):
    import jax
    import jax.numpy as jnp

    from shot_fpfh_tpu.core.subsampling import grid_subsample
    from shot_fpfh_tpu.core.transform import RigidTransform
    from shot_fpfh_tpu.models.fpfh import compute_fpfh_descriptor
    from shot_fpfh_tpu.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu.registration.icp import icp_point_to_plane
    from shot_fpfh_tpu.registration.matching import lowe_matching

    n1m = int(os.environ.get("BENCH_N_1M", 1_000_000))
    radius = 0.6
    xy = rng.uniform(-20, 20, size=(n1m, 2)).astype(np.float32)
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5))
    big = np.column_stack([xy, z]).astype(np.float32)
    # analytic surface normals (exact, free): n ∝ (-dz/dx, -dz/dy, 1)
    dzdx = (0.8 * 0.9 * np.cos(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
            + 0.4 * 2.1 * np.cos(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5))
    dzdy = (-0.8 * 0.7 * np.sin(0.9 * xy[:, 0]) * np.sin(0.7 * xy[:, 1])
            - 0.4 * 1.7 * np.sin(2.1 * xy[:, 0] + 1.0) * np.sin(1.7 * xy[:, 1] + 0.5))
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n1m, np.float32)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)

    kp_idx = np.asarray(grid_subsample(big, 0.9))
    n_kp = len(kp_idx)
    pad = -(-n_kp // 1024) * 1024 - n_kp
    kp = np.concatenate([big[kp_idx], np.full((pad, 3), 1.0e6, np.float32)])
    kp_idx_pad = np.concatenate([kp_idx, np.zeros(pad, kp_idx.dtype)])
    out = {"n_keypoints_1m": int(n_kp)}

    def warm_time(name, fn):
        jax.block_until_ready(fn())  # cold: compile + grid build
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        log(f"at-scale {name}: {dt:.2f}s warm")
        return dt

    # the descriptor grid (shared by the SHOT and FPFH legs through the
    # content cache) is built once per cloud in production; record its cost
    # separately so the warm stage times stay honest about what they exclude
    from shot_fpfh_tpu.ops.grid_hash import build_grid
    t0 = time.perf_counter()
    build_grid(big, radius / 2, extras=nrm, halo=2)
    out["grid_build_1m_seconds"] = round(time.perf_counter() - t0, 3)
    log(f"at-scale grid build (1M, cached thereafter): "
        f"{out['grid_build_1m_seconds']}s")

    shot_s = warm_time("SHOT 1M", lambda: compute_shot_descriptor(
        kp, big, nrm, radius, min_neighborhood_size=30)[0])
    out["shot_1m_seconds"] = round(shot_s, 3)
    out["desc_per_sec_1m"] = round(n_kp / shot_s, 1)

    # k-mode normals on the full 1M cloud — the get_data default path
    from shot_fpfh_tpu.models.normals import compute_normals
    normals_s = warm_time("normals 1M (k=30)", lambda: compute_normals(
        big, big, k=30))
    out["normals_1m_seconds"] = round(normals_s, 3)

    fpfh_s = warm_time("FPFH 1M", lambda: compute_fpfh_descriptor(
        kp_idx_pad, big, nrm, radius))
    out["fpfh_1m_seconds"] = round(fpfh_s, 3)

    from scipy.spatial.transform import Rotation
    R = Rotation.from_euler("xyz", [0.02, -0.01, 0.04]).as_matrix().astype(np.float32)
    t = np.array([0.08, -0.05, 0.03], np.float32)
    scan = (big - t) @ R

    def run_icp():
        res = icp_point_to_plane(
            scan, big, nrm, RigidTransform.identity(),
            d_max=0.5, voxel_size=0.5, max_iter=30, rms_threshold=1e-6,
        )
        return res

    res = run_icp()  # cold
    t0 = time.perf_counter()
    res = run_icp()
    icp_s = time.perf_counter() - t0
    log(f"at-scale ICP 1M: {icp_s:.2f}s warm ({res.n_iters} iters, rms {res.rms:.1e})")
    out["icp_1m_seconds"] = round(icp_s, 3)
    out["icp_1m_iters"] = int(res.n_iters)

    # device-resident inputs, as in production (descriptors come from the
    # device SHOT/FPFH stages)
    a = jnp.asarray(rng.normal(size=(100_000, 352)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(100_000, 352)).astype(np.float32))
    match_s = warm_time("Lowe 100k^2", lambda: lowe_matching(a, b, verbose=False)[0])
    out["match_100k2_seconds"] = round(match_s, 3)
    return out


if __name__ == "__main__":
    main()
