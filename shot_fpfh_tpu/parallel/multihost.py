"""Multi-host orchestration: N-host registration (BASELINE config #5).

The reference is single-node; multi-host is a new requirement of the JAX
rebuild (SURVEY.md intro).  Design:

- ``jax.distributed.initialize`` once per process (cross-process coordination).
- Each host loads/keeps its local shard of the keypoint work
  (``jax.make_array_from_process_local_data``); the support cloud is
  replicated per host (point clouds are small next to device memory).
- All compute reuses the single-program sharded stages in ``sharded.py`` —
  GSPMD makes an 8-chip-per-host x N-host mesh look like one mesh whose
  collectives ride NVLink within a host and the network across hosts.  The stages'
  communication profile keeps cross-host traffic tiny: descriptors never cross
  hosts except as ring tiles (matching) and 6x6/22-float psums (ICP/RANSAC).

Nothing here requires real multi-host hardware to validate the program
structure: the same code runs on any mesh, and ``scaling_report`` measures
scaling efficiency on whatever devices exist (the driver's multichip dry-run
covers N=8 virtual devices).
"""

from __future__ import annotations

import logging
import time

import jax
import numpy as np

from .mesh import make_mesh
from .sharded import ring_match, sharded_shot_descriptors

logger = logging.getLogger(__name__)


def run_multihost(
    scan_file_path: str,
    ref_file_path: str,
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    normals_k: int = 20,
    keypoint_voxel: float = 0.25,
    descriptor_choice: str = "shot_single_scale",
    radius: float = 0.5,
    min_neighborhood_size: int = 10,
    k_max_descriptor: int = 256,
    k_max_fpfh: int = 128,
    reject_threshold: float = 0.9,
    n_draws: int = 2000,
    max_inliers_distance: float = 0.1,
    d_max: float = 0.3,
    icp_voxel: float = 0.1,
    max_iter: int = 40,
    rms_threshold: float = 1e-5,
) -> dict:
    """End-to-end multi-host registration (BASELINE config #5).

    Every participating process calls this with its own ``process_id``; the
    composition is: distributed init → per-host PLY ingest (each host reads its local
    copy of the files — nothing is broadcast) → sharded normals → keypoints →
    sharded descriptors → ring matching → psum RANSAC → psum ICP.
    The mesh spans all global devices, so collectives ride NVLink within a
    host and the network across hosts; every host returns the same result dict.

    Reference: single-node only — this fulfils the rebuild's multi-host
    north-star requirement (SURVEY.md intro, §5 distributed row)."""
    from ..io.ply import get_data
    from ..models.normals import compute_normals
    from ..pipeline import RegistrationPipeline

    initialize_distributed(coordinator_address, num_processes, process_id,
                           local_device_ids)
    mesh = make_mesh()  # all global devices

    def normals_callback(q, c, **kw):
        return compute_normals(q, c, mesh=mesh, **kw)

    scan, scan_normals = get_data(
        scan_file_path, k=normals_k, normals_computation_callback=normals_callback
    )
    ref, ref_normals = get_data(
        ref_file_path, k=normals_k, normals_computation_callback=normals_callback
    )

    pipeline = RegistrationPipeline(
        scan=scan, scan_normals=scan_normals, ref=ref, ref_normals=ref_normals,
        k_max_descriptor=k_max_descriptor, k_max_fpfh=k_max_fpfh, mesh=mesh,
    )
    pipeline.select_keypoints("subsampling", neighborhood_size=keypoint_voxel)
    pipeline.compute_descriptors(
        radius=radius, descriptor_choice=descriptor_choice,
        subsample_support=False, min_neighborhood_size=min_neighborhood_size,
    )
    pipeline.find_descriptors_matches("ratio", reject_threshold=reject_threshold)
    tf_ransac, inlier_ratio = pipeline.run_ransac(
        n_draws=n_draws, draw_size=4, max_inliers_distance=max_inliers_distance
    )
    tf_icp, rms, converged = pipeline.run_icp(
        "point_to_plane", tf_ransac, d_max=d_max, voxel_size=icp_voxel,
        max_iter=max_iter, rms_threshold=rms_threshold,
    )
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "n_devices": jax.device_count(),
        "rotation": np.asarray(tf_icp.rotation).tolist(),
        "translation": np.asarray(tf_icp.translation).tolist(),
        "ransac_inlier_ratio": float(inlier_ratio),
        "icp_rms": float(rms),
        "icp_converged": bool(converged),
        "n_matches": int(len(pipeline.matches[0])),
        "stages": pipeline.metrics.summary(),
    }


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Bring up multi-process coordination; no-op on single-process runs.

    ``local_device_ids`` restricts this process to those local GPUs: several
    processes on one host each take one card with ``[process_id]`` (None:
    every local device is visible, one process per host)."""
    if num_processes is None or num_processes <= 1:
        logger.info("single-process run: skipping jax.distributed.initialize")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def host_local_keypoint_shard(keypoints: np.ndarray) -> np.ndarray:
    """The contiguous keypoint block this host is responsible for."""
    n = len(keypoints)
    p, np_total = jax.process_index(), jax.process_count()
    per = -(-n // np_total)
    return keypoints[p * per: (p + 1) * per]


def global_keypoint_array(local_block: np.ndarray, mesh):
    """Assemble the process-local blocks into one global row-sharded array."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(mesh.axis_names[0], None))
    return jax.make_array_from_process_local_data(sharding, local_block)


def scaling_report(
    n_keypoints: int = 2048,
    n_support: int = 20000,
    radius: float = 0.9,
    k_max: int = 128,
    device_counts: tuple = (1, 0),
    stage: str = "shot",
    reps: int = 3,
) -> dict:
    """Measure sharded-stage scaling efficiency across device counts
    (0 = all devices).  ``stage`` ∈ {"shot", "fpfh", "matching"}.
    Returns {n_devices: items_per_sec, "efficiency": top/base ratio}.

    The number is only meaningful on real devices (on a virtual CPU mesh the
    "devices" share the same cores); ``bench.py`` runs this on hardware and
    the GPU-only test asserts the ≥80% BASELINE target when ≥2 real chips
    are visible."""
    from .sharded import ring_match, sharded_fpfh

    rng = np.random.default_rng(0)
    support = rng.normal(size=(n_support, 3)).astype(np.float32) * 4
    normals = rng.normal(size=(n_support, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    keypoints = support[:n_keypoints]
    kp_idx = np.arange(n_keypoints, dtype=np.int32)
    rng2 = np.random.default_rng(1)
    desc_a = rng2.normal(size=(n_keypoints, 352)).astype(np.float32)
    desc_b = rng2.normal(size=(n_keypoints, 352)).astype(np.float32)

    results = {}
    for count in device_counts:
        mesh = make_mesh(count)
        n_dev = mesh.devices.size

        if stage == "shot":
            def run():
                return sharded_shot_descriptors(
                    keypoints, support, normals, radius, mesh,
                    k_max=k_max, min_neighborhood_size=5,
                )
        elif stage == "fpfh":
            def run():
                return sharded_fpfh(
                    kp_idx, support, normals, radius, mesh,
                    n_bins=5, k_max=k_max,
                )
        elif stage == "matching":
            def run():
                return ring_match(desc_a, desc_b, mesh)
        else:
            raise ValueError(f"unknown stage {stage!r}")

        run()  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        per_sec = n_keypoints * reps / (time.perf_counter() - t0)
        results[n_dev] = per_sec
        logger.info("%s, %d device(s): %.0f items/s", stage, n_dev, per_sec)
    counts = sorted(k for k in results if isinstance(k, int))
    if len(counts) > 1:
        base, top = counts[0], counts[-1]
        eff = results[top] / (results[base] * top / base)
        logger.info("%s scaling efficiency %d->%d devices: %.0f%%",
                    stage, base, top, eff * 100)
        results["efficiency"] = eff
    return results
