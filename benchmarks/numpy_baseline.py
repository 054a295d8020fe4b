"""CPU NumPy baseline mirroring the reference implementation's architecture.

The reference computes SHOT one keypoint at a time: a KDTree radius query on
the master process, then per-keypoint NumPy vectorized local-RF + histogram
work fanned over a multiprocessing.Pool (shot_parallelization.py:16-312).
This module reproduces that architecture (KDTree + per-keypoint Python loop +
process pool) so `bench.py` can measure an honest descriptors/sec baseline on
the same workload the JAX path runs — the reference itself publishes no
numbers (BASELINE.md).

This is a re-derivation for benchmarking, not a import of the reference.
"""

from __future__ import annotations

import numpy as np

from scipy.spatial import cKDTree


def _azimuth_idx(x, y):
    a = (y > 0) | ((y == 0) & (x < 0))
    half = (x > 0) | ((x == 0) & (y > 0))
    corner = np.where((x * y > 0) | (x == 0), np.abs(x) < np.abs(y), np.abs(x) > np.abs(y))
    return 4 * a.astype(int) + 2 * np.logical_xor(half, a).astype(int) + corner.astype(int)


def _local_rf(point, neighbors, radius):
    if len(neighbors) == 0:
        return np.eye(3)
    centered = neighbors - point
    d = np.linalg.norm(centered, axis=1)
    w = radius - d
    cov = (centered * w[:, None]).T @ centered / max(w.sum(), 1e-12)
    _, vec = np.linalg.eigh(cov)
    x, z = vec[:, 2].copy(), vec[:, 0].copy()
    if ((centered @ x) < 0).sum() > ((centered @ x) >= 0).sum():
        x = -x
    if ((centered @ z) < 0).sum() > ((centered @ z) >= 0).sum():
        z = -z
    return np.stack([x, np.cross(z, x), z], axis=1)


def _single_shot(point, neighbors, nb_normals, radius, rf, min_size):
    desc = np.zeros((11, 8, 2, 2))
    rho_all = np.linalg.norm(neighbors - point, axis=1)
    keep = rho_all > 0
    if keep.sum() <= min_size:
        return np.zeros(352)
    nb, nn, rho = neighbors[keep], nb_normals[keep], rho_all[keep]
    local = (nb - point) @ rf
    cosine = np.clip(nn @ rf[:, 2], -1, 1)
    theta = np.arctan2(local[:, 1], local[:, 0])
    phi = np.arccos(np.clip(local[:, 2] / rho, -1, 1))

    cos_pos = (cosine + 1.0) * 11 / 2.0 - 0.5
    cos_idx = np.rint(cos_pos).astype(int)
    az = _azimuth_idx(local[:, 0], local[:, 1])
    elev = (local[:, 2] > 0).astype(int)
    rad = (rho > radius / 2).astype(int)

    delta = cos_pos - cos_idx
    s = np.sign(delta)
    ad = np.abs(delta)
    np.add.at(desc, ((cos_idx + s).astype(int) % 11, az, elev, rad), ad)
    np.add.at(desc, (cos_idx, az, elev, rad), 1 - ad)

    half = radius / 2
    inner = ((rho > half) & (rho < 0.75 * radius)) * (0.75 * radius - rho) / half
    outer = ((rho < half) & (rho > 0.25 * radius)) * (rho - 0.25 * radius) / half
    cur = (rho < half) * (1 - np.abs(rho - 0.25 * radius) / half) + (rho > half) * (
        1 - np.abs(rho - 0.75 * radius) / half
    )
    np.add.at(desc, (cos_idx, az, elev, np.ones_like(rad)), outer * (rad == 0))
    np.add.at(desc, (cos_idx, az, elev, np.zeros_like(rad)), inner * (rad == 1))
    np.add.at(desc, (cos_idx, az, elev, rad), cur)

    hp = np.pi / 2
    edge = np.abs(phi - hp) < 1e-10
    upper = (((phi > hp) | (edge & (local[:, 2] <= 0))) & (phi <= 0.75 * np.pi)) * (
        0.75 * np.pi - phi
    ) / hp
    lower = (((phi < hp) & (~edge | (local[:, 2] > 0))) & (phi >= 0.25 * np.pi)) * (
        phi - 0.25 * np.pi
    ) / hp
    vcur = (phi < hp) * (1 - np.abs(phi - 0.25 * np.pi) / hp) + (phi >= hp) * (
        1 - np.abs(phi - 0.75 * np.pi) / hp
    )
    np.add.at(desc, (cos_idx, az, np.ones_like(elev), rad), upper * (elev == 0))
    np.add.at(desc, (cos_idx, az, np.zeros_like(elev), rad), lower * (elev == 1))
    np.add.at(desc, (cos_idx, az, elev, rad), vcur)

    az_size = 2 * np.pi / 8
    d_az = np.clip((theta - (-np.pi + az * az_size)) / az_size - 0.5, -0.5, 0.5)
    s_az = np.sign(d_az)
    a_az = np.abs(d_az)
    np.add.at(desc, (cos_idx, (az + s_az).astype(int) % 8, elev, rad), a_az)
    np.add.at(desc, (cos_idx, az, elev, rad), 1 - a_az)

    flat = desc.ravel()
    n = np.linalg.norm(flat)
    return flat / n if n > 0 else np.zeros(352)


def _worker(args):
    return _single_shot(*args)


def shot_descriptors_cpu(
    keypoints: np.ndarray,
    cloud: np.ndarray,
    normals: np.ndarray,
    radius: float,
    min_neighborhood_size: int = 10,
    n_procs: int = 8,
) -> np.ndarray:
    """Reference-architecture SHOT: KDTree radius query + per-keypoint pool."""
    neighborhoods = [np.asarray(nb, dtype=np.intp) for nb in
                     cKDTree(cloud).query_ball_point(keypoints, radius)]

    tasks = []
    for i, kp in enumerate(keypoints):
        nb = cloud[neighborhoods[i]]
        rf = _local_rf(kp, nb, radius)
        tasks.append((kp, nb, normals[neighborhoods[i]], radius, rf, min_neighborhood_size))

    if n_procs > 1:
        from multiprocessing import Pool

        with Pool(n_procs) as pool:
            out = pool.map(_worker, tasks, chunksize=max(1, len(tasks) // (2 * n_procs)))
    else:
        out = [_worker(t) for t in tasks]
    return np.stack(out)


def match_descriptors_cpu(scan_desc: np.ndarray, ref_desc: np.ndarray) -> np.ndarray:
    """Reference-style brute-force cdist + argmin matching."""
    try:
        from scipy.spatial.distance import cdist

        return cdist(scan_desc, ref_desc).argmin(axis=1)
    except ImportError:  # pragma: no cover
        d = np.linalg.norm(scan_desc[:, None] - ref_desc[None], axis=-1)
        return d.argmin(axis=1)
