"""Measure the ACTUAL reference pipeline (BASELINE.md protocol).

Runs `/root/reference`'s own code (shot_fpfh package, pure NumPy/sklearn/
multiprocessing) on:

1. the bench workload (same terrain cloud + keypoint set as bench.py —
   SHOT-352 at radius 0.9, min-100 neighborhoods, plus cdist matching) to
   get a *measured* reference descriptors/s with its real n_procs=8 pool, and
2. a deterministic golden cloud pair, end-to-end (normals → subsampling
   keypoints → SHOT → basic matching → RANSAC → point-to-plane ICP) to record
   per-stage seconds and the final transform errors vs ground truth — the
   ATE bound the JAX build must land inside.

Writes BASELINE_measured.json at the repo root; bench.py reads it to report
``vs_reference_measured`` and tests/test_reference_parity.py asserts the
accuracy bound.  Run on CPU only (no jax import needed):

    python benchmarks/measure_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE = "/root/reference"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REFERENCE)
sys.path.insert(0, REPO)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --- workload generators (identical to bench.py / golden tests) -------------
def make_terrain(n, rng, scale=10.0, n_bumps=40):
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-scale, scale, size=(n_bumps, 2))
    heights = rng.uniform(-2.0, 2.0, size=n_bumps)
    widths = rng.uniform(0.5, 2.5, size=n_bumps) * (scale / 10.0) * (40 / n_bumps) ** 0.5
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w**2))
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return pts.astype(np.float32)


def make_golden_pair(n=2500, seed=21):
    """Deterministic pair saved to benchmarks/golden_pair.npz so the JAX
    parity test consumes byte-identical inputs."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-2, 2, size=(12, 2))
    heights = rng.uniform(-0.6, 0.6, size=12)
    widths = rng.uniform(0.2, 0.7, size=12)
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w**2))
    ref = np.column_stack([xy, z]) + rng.normal(scale=0.003, size=(n, 3))

    ang = 0.35
    axis = np.array([0.2, -0.3, 0.93])
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    t = np.array([0.3, -0.2, 0.15])
    # scan -> ref ground truth: ref = scan @ rot_gt.T + t_gt
    rot_gt, t_gt = rot, t
    scan = (ref - t_gt) @ rot_gt
    return scan, ref, rot_gt, t_gt


def measure_bench_workload() -> dict:
    """Reference SHOT + matching on the bench.py workload (its real pool)."""
    from scipy.spatial.distance import cdist
    from shot_fpfh.descriptors import ShotMultiprocessor

    n_support = int(os.environ.get("BENCH_N_SUPPORT", 50_000))
    n_keypoints = int(os.environ.get("BENCH_N_KEYPOINTS", 4096))
    n_measure = int(os.environ.get("REF_N_MEASURE", 512))
    radius = float(os.environ.get("BENCH_RADIUS", 0.9))

    rng = np.random.default_rng(0)
    cloud = make_terrain(n_support, rng).astype(np.float64)
    normals = rng.normal(size=(n_support, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    kp_idx = rng.choice(n_support, n_keypoints, replace=False)
    keypoints = cloud[kp_idx][:n_measure]

    log(f"reference SHOT: {n_measure} keypoints, 50k cloud, n_procs=8 ...")
    t0 = time.perf_counter()
    with ShotMultiprocessor(
        normalize=True, min_neighborhood_size=100, n_procs=8,
        disable_progress_bar=True, verbose=False,
    ) as smp:
        desc = smp.compute_descriptor_single_scale(
            point_cloud=cloud, normals=normals, keypoints=keypoints,
            radius=radius,
        )
    shot_s = time.perf_counter() - t0
    log(f"  SHOT: {shot_s:.2f}s ({n_measure / shot_s:.0f} desc/s)")

    t0 = time.perf_counter()
    d = cdist(desc, desc)
    d.argmin(axis=1)
    match_s = time.perf_counter() - t0
    # extrapolate the matching leg to the full keypoint set (cdist is O(K^2))
    match_full = match_s * (n_keypoints / n_measure) ** 2
    per_desc = shot_s / n_measure + match_full / n_keypoints
    desc_per_sec = 1.0 / per_desc
    log(f"  matching {n_measure}^2: {match_s:.3f}s -> {n_keypoints}^2 "
        f"extrapolated {match_full:.2f}s")
    log(f"  reference measured: {desc_per_sec:.0f} desc/s (SHOT+matching)")
    return {
        "n_keypoints_measured": n_measure,
        "n_support": n_support,
        "radius": radius,
        "n_procs": 8,
        "shot_seconds": shot_s,
        "matching_seconds_extrapolated": match_full,
        "descriptors_per_sec": desc_per_sec,
        "valid_fraction": float(np.any(desc, axis=1).mean()),
    }


def measure_golden_pipeline() -> dict:
    """Reference end-to-end on the golden pair; records per-stage seconds and
    the final transform error vs ground truth (the ATE bound)."""
    from shot_fpfh.core import RigidTransform, grid_subsampling
    from shot_fpfh.descriptors import ShotMultiprocessor, compute_normals
    from shot_fpfh.icp import icp_point_to_plane
    from shot_fpfh.matching import basic_matching, ransac_on_matches

    scan, ref, rot_gt, t_gt = make_golden_pair()
    np.savez_compressed(
        os.path.join(REPO, "benchmarks", "golden_pair.npz"),
        scan=scan, ref=ref, rot_gt=rot_gt, t_gt=t_gt,
    )
    stages = {}

    t0 = time.perf_counter()
    scan_n = compute_normals(scan, scan, k=20)
    ref_n = compute_normals(ref, ref, k=20)
    stages["normals"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scan_kp = grid_subsampling(scan, 0.25)
    ref_kp = grid_subsampling(ref, 0.25)
    stages["keypoints"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ShotMultiprocessor(
        normalize=True, min_neighborhood_size=10, n_procs=8,
        disable_progress_bar=True, verbose=False,
    ) as smp:
        scan_desc = smp.compute_descriptor_single_scale(
            point_cloud=scan, normals=scan_n, keypoints=scan[scan_kp], radius=0.5
        )
        ref_desc = smp.compute_descriptor_single_scale(
            point_cloud=ref, normals=ref_n, keypoints=ref[ref_kp], radius=0.5
        )
    stages["shot"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m_scan, m_ref = basic_matching(scan_desc, ref_desc)
    stages["matching"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ratio, tf_ransac = ransac_on_matches(
        m_scan, m_ref, scan[scan_kp], ref[ref_kp],
        n_draws=2000, draw_size=4, distance_threshold=0.1,
        disable_progress_bar=True,
    )
    stages["ransac"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tf_icp, rms, converged = icp_point_to_plane(
        scan, ref, ref_n, tf_ransac, d_max=0.3, voxel_size=0.1,
        max_iter=40, rms_threshold=1e-5, disable_progress_bar=True,
    )
    stages["icp"] = time.perf_counter() - t0

    # errors vs ground truth
    def rot_angle(r1, r2):
        c = (np.trace(r1.T @ r2) - 1) / 2
        return float(np.arccos(np.clip(c, -1, 1)))

    moved = scan @ tf_icp.rotation.T + tf_icp.translation
    gt_moved = scan @ rot_gt.T + t_gt
    ate_rmse = float(np.sqrt(np.mean(np.sum((moved - gt_moved) ** 2, axis=1))))
    result = {
        "stages_seconds": stages,
        "total_seconds": sum(stages.values()),
        "n_points": int(len(scan)),
        "n_keypoints": [int(len(scan_kp)), int(len(ref_kp))],
        "n_matches": int(len(m_scan)),
        "ransac_inlier_ratio": float(ratio),
        "icp_rms": float(rms),
        "icp_converged": bool(converged),
        "rotation": np.asarray(tf_icp.rotation).tolist(),
        "translation": np.asarray(tf_icp.translation).tolist(),
        "rotation_error_rad": rot_angle(np.asarray(tf_icp.rotation), rot_gt),
        "translation_error": float(
            np.linalg.norm(np.asarray(tf_icp.translation) - t_gt)
        ),
        "ate_rmse": ate_rmse,
    }
    log(f"reference golden pipeline: {result['total_seconds']:.1f}s total, "
        f"rot err {result['rotation_error_rad']:.2e} rad, "
        f"ATE RMSE {ate_rmse:.2e}")
    return result


def main() -> None:
    out = {
        "machine": os.uname().nodename,
        "protocol": "BASELINE.md — measured on the actual reference package "
                    "(/root/reference) with its multiprocessing pool",
        "bench_workload": measure_bench_workload(),
        "golden_pipeline": measure_golden_pipeline(),
    }
    path = os.path.join(REPO, "BASELINE_measured.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}")
    print(json.dumps({"reference_desc_per_sec":
                      out["bench_workload"]["descriptors_per_sec"]}))


if __name__ == "__main__":
    main()
