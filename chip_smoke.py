"""Smoke run of the registration pipeline on one NVIDIA GPU.

    python chip_smoke.py [--seed 0]      # one card: every phase below
    python chip_smoke.py --four          # four cards: the sharded CLI path only

Phases, in one process (JAX reserves most of the card when it starts, so no
second process may touch it):

- device: refuses to run unless JAX's first device is a GPU; prints the
  card's name and power limit;
- kernel: the Pallas Triton matching kernel (``ops.match_triton``), compiled
  for the card, against the XLA tile scan (bf16 and the f32 reference) at
  the pipeline's descriptor widths, on the pipeline's own SHOT descriptors
  and on 100k random rows;
- pair: a KITTI-scale (~120k points per scan) synthetic scan/ref ``.ply``
  pair with a known rigid transform, registered through
  ``shot_fpfh_tpu.cli.main`` three ways (staged SHOT, staged FPFH,
  ``--fused`` SHOT); the recovered ICP transform must match the known one;
- numerics: normals, SHOT, FPFH and ICP on the GPU against the same code on
  the host CPU backend;
- scale: 1M-point normals, SHOT, FPFH and ICP and a 100k x 100k x 352 Lowe
  match, with warm seconds and peak device memory.

Every dataset is generated from ``--seed``.  A failed check raises; the last
line of standard output is a JSON object with ``"ok": true`` and the device
only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KITTI_POINTS = 120_000      # points per scan (64-beam scanner, KITTI odometry)
KITTI_HALF_EXTENT = 40.0    # metres: the scene spans 80 m x 80 m
SCALE_POINTS = 1_000_000
SCALE_HALF_EXTENT = 20.0    # metres: 1M points over 40 m x 40 m
KERNEL_ROWS = 5_000         # rows per side of the width checks
KERNEL_BIG_ROWS = 100_000   # rows per side of the at-scale check


def require_gpu():
    """The first JAX device, which must be a GPU; anything else exits."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def warm_seconds(fn):
    """(result, seconds of the second call); the first call compiles."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ------------------------------------------------------------------ data ---
def terrain(n: int, rng, half: float, n_bumps: int):
    """Gaussian bumps on a plane, with analytic unit normals (up-facing)."""
    xy = rng.uniform(-half, half, size=(n, 2))
    z = np.zeros(n)
    dzdx = np.zeros(n)
    dzdy = np.zeros(n)
    centers = rng.uniform(-half, half, size=(n_bumps, 2))
    heights = rng.uniform(-2.0, 2.0, size=n_bumps)
    widths = (rng.uniform(0.5, 2.5, size=n_bumps) * (half / 10.0)
              * (40 / n_bumps) ** 0.5)
    for c, h, w in zip(centers, heights, widths):
        g = h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w * w))
        z += g
        dzdx -= g * (xy[:, 0] - c[0]) / (w * w)
        dzdy -= g * (xy[:, 1] - c[1]) / (w * w)
    pts = np.column_stack([xy, z])
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n)])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                              math.sin(ry), math.cos(rz), math.sin(rz))
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return r_z @ r_y @ r_x


def rotation_error(r_est, r_true) -> float:
    """Angle of r_est^T r_true, from ||r_est - r_true||_F = 2√2 sin(θ/2)
    (accurate for the small angles arccos of the trace rounds to zero)."""
    d = np.linalg.norm(np.asarray(r_est, np.float64) - r_true)
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def kitti_pair(rng, out_dir: str):
    """A scan/ref pair of one synthetic street-scale terrain: each keeps its
    own 90% of the surface samples with independent 5 mm noise; the scan is
    then moved by a known rigid transform.  Returns the paths and the
    transform (rotation, translation) that maps the scan onto the ref."""
    from shot_fpfh_tpu.io.ply import write_ply

    n_surface = int(KITTI_POINTS / 0.9)
    pts, nrm = terrain(n_surface, rng, KITTI_HALF_EXTENT,
                       n_bumps=int(0.1 * (2 * KITTI_HALF_EXTENT) ** 2))
    rot = rotation(0.02, -0.015, 0.17)
    trans = np.array([2.0, -1.5, 0.3])
    paths = {}
    for name in ("ref", "scan"):
        keep = rng.random(n_surface) < 0.9
        p = pts[keep] + rng.normal(scale=0.005, size=(keep.sum(), 3))
        q = nrm[keep]
        if name == "scan":           # ref = rot @ scan + trans
            p = (p - trans) @ rot
            q = q @ rot
        paths[name] = os.path.join(out_dir, f"{name}.ply")
        write_ply(paths[name], [p.astype(np.float32), q.astype(np.float32)],
                  ["x", "y", "z", "nx", "ny", "nz"])
    return paths, rot, trans


# --------------------------------------------------------------- phases ---
def smoke_config(out_dir: str) -> str:
    """The shipped default config, except that the post-ICP evaluation does
    not ask for keypoint-to-keypoint inliers: the two synthetic scans'
    keypoints are independent voxel samples, so that rate is near zero for
    any transform.  The overlap criterion stays, and the known transform is
    checked directly."""
    from shot_fpfh_tpu import cli

    with open(cli._DEFAULT_CONFIG) as f:
        text = f.read()
    assert "inliers_threshold: 0.5" in text
    path = os.path.join(out_dir, "smoke.yaml")
    with open(path, "w") as f:
        f.write(text.replace("inliers_threshold: 0.5", "inliers_threshold: 0.0"))
    return path


def cli_run(paths, out_dir, tag, extra):
    from shot_fpfh_tpu import cli

    metrics = os.path.join(out_dir, f"{tag}.json")
    argv = ["--scan_file_path", paths["scan"], "--ref_file_path",
            paths["ref"], "--conf_file_path", "", "--output_dir", out_dir,
            "--config", smoke_config(out_dir),
            "--disable_ply_writing", "--metrics_json", metrics,
            "--selection_algorithm", "subsampling", "--neighborhood_size",
            "2.0", "--radius", "3.0"] + extra
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    with open(metrics) as f:
        m = json.load(f)
    check(rc == 0, f"{tag}: CLI exit code {rc} (registration accepted)")
    return m, wall


def transform_errors(m, rot, trans):
    t = np.asarray(m["transform_icp"], np.float64)
    return rotation_error(t[:3, :3], rot), float(np.linalg.norm(t[:3, 3] - trans))


def pair_phase(rng, work, runs=None):
    log("== pair phase (KITTI scale, CLI) ==")
    paths, rot, trans = kitti_pair(rng, work)
    extent = 2 * KITTI_HALF_EXTENT
    runs = runs or [
        ("staged_shot", ["--descriptor_choice", "shot_single_scale",
                         "--n_devices", "1"]),
        ("staged_shot_warm", ["--descriptor_choice", "shot_single_scale",
                              "--n_devices", "1"]),
        ("staged_fpfh", ["--descriptor_choice", "fpfh", "--n_devices", "1"]),
        ("fused_shot", ["--descriptor_choice", "shot_single_scale",
                        "--fused", "--n_devices", "1"]),
    ]
    results = {}
    for tag, extra in runs:
        m, wall = cli_run(paths, work, tag, extra)
        r_err, t_err = transform_errors(m, rot, trans)
        stages = {s["stage"]: round(s["seconds"], 4) for s in m["stages"]}
        log(f"{tag}: wall {wall:.3f} s, stages {json.dumps(stages)}, "
            f"rotation error {r_err:.3e} rad, translation error {t_err:.3e} m")
        check(r_err < 1e-3, f"{tag}: rotation error {r_err:.2e} < 1e-3 rad")
        check(t_err < 1e-3 * extent,
              f"{tag}: translation error {t_err:.2e} < {1e-3 * extent:.2e} m")
        results[tag] = {"wall": wall, "stages": stages, "matrix":
                        np.asarray(m["transform_icp"]), "m": m}
    if "staged_shot_warm" in results:
        log(f"cold start (staged SHOT, first minus warm run): "
            f"{results['staged_shot']['wall'] - results['staged_shot_warm']['wall']:.3f} s")
    return paths, results


def kernel_phase(rng, dev):
    import jax.numpy as jnp

    from shot_fpfh_tpu.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu.core.subsampling import grid_subsample
    from shot_fpfh_tpu.ops.match_triton import top2_triton
    from shot_fpfh_tpu.registration.matching import _top_scan

    log("== kernel phase (Triton top-2 match vs XLA tile scan) ==")

    def compare(a, b, tag, min_agree):
        """The bf16 kernel against the bf16 tile scan (the same operand
        rounding: ``min_agree``, d1² within 2e-3) and against the f32 tile
        scan (the reference: >= 0.97, near-ties may flip; d1² within 2^-7,
        the most that rounding both operands to bf16 can move it)."""
        a, b = jnp.asarray(a), jnp.asarray(b)
        v = jnp.ones(b.shape[0], bool)
        k = [np.asarray(x) for x in top2_triton(a, b, v)]
        for bf16, agree_floor, rtol in ((True, min_agree, 2e-3),
                                        (False, 0.97, 2.0 ** -7)):
            s = [np.asarray(x) for x in _top_scan(a, b, v, bf16, True)]
            agree = float((k[0] == s[0]).mean())
            # relative to the squared norms d1² = ‖a‖² + ‖b‖² − 2a·b is
            # formed from: both matchers share the expansion's f32
            # cancellation, which dominates for near-duplicate rows
            scale = (np.sum(np.asarray(a) ** 2, axis=1)
                     + np.sum(np.asarray(b)[s[0]] ** 2, axis=1))
            rel = float(np.max(np.abs(k[1] - s[1]) / scale))
            ref = "bf16 scan" if bf16 else "f32 scan"
            log(f"{tag} vs {ref}: index agreement {agree:.5f}, d1 rel {rel:.2e}")
            check(agree >= agree_floor,
                  f"{tag} vs {ref}: agreement {agree:.4f} >= {agree_floor}")
            check(rel <= rtol, f"{tag} vs {ref}: d1 rel {rel:.2e} <= {rtol:.2e}")

    for dim in (33, 352, 704):
        a = rng.normal(size=(KERNEL_ROWS, dim)).astype(np.float32)
        b = rng.normal(size=(KERNEL_ROWS, dim)).astype(np.float32)
        compare(a, b, f"random {KERNEL_ROWS}^2 x {dim}", 0.97)

    # the pipeline's own descriptors: SHOT of two noisy copies of a surface
    pts, nrm = terrain(60_000, rng, 12.0, n_bumps=60)
    pts = pts.astype(np.float32)
    nrm = nrm.astype(np.float32)
    kp = pts[np.asarray(grid_subsample(pts, 0.5))]
    other = pts + rng.normal(scale=0.003, size=pts.shape).astype(np.float32)
    da, _ = compute_shot_descriptor(kp, pts, nrm, 1.0, min_neighborhood_size=30)
    db, _ = compute_shot_descriptor(kp, other, nrm, 1.0,
                                    min_neighborhood_size=30)
    da, db = np.asarray(da), np.asarray(db)
    ok = np.any(da != 0, axis=1) & np.any(db != 0, axis=1)
    compare(da[ok], db[ok], f"pipeline SHOT {int(ok.sum())} x 352", 1.0)

    a = rng.normal(size=(KERNEL_BIG_ROWS, 352)).astype(np.float32)
    b = rng.normal(size=(KERNEL_BIG_ROWS, 352)).astype(np.float32)
    compare(a, b, f"random {KERNEL_BIG_ROWS}^2 x 352", 0.97)


def numerics_phase(rng):
    """The same code on the GPU and on the host CPU backend."""
    import jax

    from shot_fpfh_tpu.core.subsampling import grid_subsample
    from shot_fpfh_tpu.core.transform import RigidTransform
    from shot_fpfh_tpu.models.fpfh import compute_fpfh_descriptor
    from shot_fpfh_tpu.models.normals import compute_normals
    from shot_fpfh_tpu.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu.registration.icp import icp_point_to_plane

    log("== numerics phase (GPU vs host CPU backend) ==")
    pts, nrm = terrain(30_000, rng, 8.0, n_bumps=40)
    pts = pts.astype(np.float32)
    nrm = nrm.astype(np.float32)
    kp_idx = np.asarray(grid_subsample(pts, 0.6)).astype(np.int32)
    kp = pts[kp_idx]
    rot = rotation(0.01, 0.02, -0.05)
    trans = np.array([0.05, -0.03, 0.02])
    scan = ((pts - trans) @ rot).astype(np.float32)

    def run():
        out = {
            "normals": compute_normals(pts, pts, k=30),
            "shot": compute_shot_descriptor(kp, pts, nrm, 0.8,
                                            min_neighborhood_size=30)[0],
            "fpfh": compute_fpfh_descriptor(kp_idx, pts, nrm, 0.8),
        }
        res = icp_point_to_plane(scan, pts, nrm, RigidTransform.identity(),
                                 d_max=0.3, voxel_size=0.1, max_iter=30,
                                 rms_threshold=1e-7)
        out["transform"] = res.transform.as_matrix()
        return {k: np.asarray(v, np.float64) for k, v in out.items()}

    gpu = run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run()
    n_g, n_c = gpu["normals"], cpu["normals"]
    sign = np.where(np.sum(n_g * n_c, axis=1, keepdims=True) < 0, -1.0, 1.0)
    diffs = {
        "normals": np.abs(n_g - sign * n_c),
        "shot": np.abs(gpu["shot"] - cpu["shot"]),
        "fpfh": np.abs(gpu["fpfh"] - cpu["fpfh"]),
        "transform": np.abs(gpu["transform"] - cpu["transform"]),
    }
    for name, d in diffs.items():
        log(f"{name}: max |GPU - CPU| {d.max():.3e}, "
            f"rows over 1e-4: {int((d.reshape(len(d), -1) > 1e-4).any(1).sum())}"
            f" of {len(d)}")
    check(diffs["normals"].max() <= 1e-4, "normals |Δ| <= 1e-4 up to sign")
    check(diffs["shot"].max() <= 1e-4, "SHOT |Δ| <= 1e-4")
    check(diffs["fpfh"].max() <= 1e-4, "FPFH |Δ| <= 1e-4")
    check(diffs["transform"].max() <= 1e-5, "ICP transform |Δ| <= 1e-5")


def scale_phase(rng, dev):
    import jax.numpy as jnp

    from shot_fpfh_tpu.core.subsampling import grid_subsample
    from shot_fpfh_tpu.core.transform import RigidTransform
    from shot_fpfh_tpu.models.fpfh import compute_fpfh_descriptor
    from shot_fpfh_tpu.models.normals import compute_normals
    from shot_fpfh_tpu.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu.ops.grid_hash import (build_grid, kth_distance_bound,
                                             quantized_kth_radius)
    from shot_fpfh_tpu.ops.neighbors import knn
    from shot_fpfh_tpu.registration.icp import icp_point_to_plane
    from shot_fpfh_tpu.registration.matching import lowe_matching

    log(f"== scale phase ({SCALE_POINTS} points) ==")
    n = SCALE_POINTS
    radius = 0.6
    xy = rng.uniform(-SCALE_HALF_EXTENT, SCALE_HALF_EXTENT,
                     size=(n, 2)).astype(np.float32)
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5))
    big = np.column_stack([xy, z]).astype(np.float32)
    dzdx = (0.8 * 0.9 * np.cos(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
            + 0.4 * 2.1 * np.cos(2.1 * xy[:, 0] + 1.0)
            * np.cos(1.7 * xy[:, 1] + 0.5))
    dzdy = (-0.8 * 0.7 * np.sin(0.9 * xy[:, 0]) * np.sin(0.7 * xy[:, 1])
            - 0.4 * 1.7 * np.sin(2.1 * xy[:, 0] + 1.0)
            * np.sin(1.7 * xy[:, 1] + 0.5))
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n, np.float32)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    kp_idx = np.asarray(grid_subsample(big, 0.9))
    n_kp = len(kp_idx)
    pad = -(-n_kp // 1024) * 1024 - n_kp
    kp = np.concatenate([big[kp_idx], np.full((pad, 3), 1.0e6, np.float32)])
    kp_idx_pad = np.concatenate([kp_idx, np.zeros(pad, kp_idx.dtype)])
    out = {"n_keypoints": n_kp}

    def stage(name, fn):
        res, sec = warm_seconds(fn)
        out[name] = sec
        log(f"{name}: {sec:.4f} s warm, peak device memory "
            f"{peak_bytes(dev) / 2**30:.2f} GiB")
        return res

    t0 = time.perf_counter()
    build_grid(big, radius / 2, extras=nrm, halo=2)
    log(f"grid build (1M, descriptor grid, cold): "
        f"{time.perf_counter() - t0:.3f} s")

    normals = stage("normals_1m_k30", lambda: compute_normals(big, big, k=30))
    check(np.isfinite(np.asarray(normals)).all(), "1M normals finite")
    cosines = np.abs(np.sum(np.asarray(normals) * nrm, axis=1))
    check(np.quantile(cosines, 0.01) > 0.99,
          f"1M normals match the analytic ones (1% quantile |cos| "
          f"{np.quantile(cosines, 0.01):.4f})")
    # the two passes around the streaming covariance, timed alone
    sample = jnp.asarray(big[::n // 512][:512])
    big_j = jnp.asarray(big)
    kth = stage("kth_distance_bound_1m",
                lambda: kth_distance_bound(sample, big_j, 30))
    stage("miss_net_knn_2048x1m", lambda: knn(big_j[:2048], big_j, 30).dist)
    grid = build_grid(big, quantized_kth_radius(np.asarray(kth)))
    moved = n * int(grid.window_cap) * 16   # f32 xyz row + int32 slot each
    log(f"normals window bytes {moved:.3e} -> "
        f"{moved / out['normals_1m_k30'] / 1e12:.3f} TB/s achieved "
        f"(window_cap {int(grid.window_cap)})")

    desc = stage("shot_1m", lambda: compute_shot_descriptor(
        kp, big, nrm, radius, min_neighborhood_size=30)[0])
    check(np.isfinite(np.asarray(desc)).all() and desc.shape == (len(kp), 352),
          "SHOT 1M finite, (Q, 352)")
    fp = stage("fpfh_1m", lambda: compute_fpfh_descriptor(
        kp_idx_pad, big, nrm, radius))
    check(np.isfinite(np.asarray(fp)).all() and fp.shape == (len(kp), 125),
          "FPFH 1M finite, (Q, 125)")

    rot = rotation(0.02, -0.01, 0.04)
    trans = np.array([0.08, -0.05, 0.03])
    scan = ((big - trans) @ rot).astype(np.float32)
    res = stage("icp_1m", lambda: icp_point_to_plane(
        scan, big, nrm, RigidTransform.identity(), d_max=0.5, voxel_size=0.5,
        max_iter=30, rms_threshold=1e-6))
    r_err = rotation_error(np.asarray(res.transform.rotation), rot)
    t_err = float(np.linalg.norm(np.asarray(res.transform.translation) - trans))
    log(f"ICP 1M: {int(res.n_iters)} iterations, rotation error {r_err:.2e} "
        f"rad, translation error {t_err:.2e} m")
    check(r_err < 1e-3 and t_err < 2e-3 * SCALE_HALF_EXTENT,
          "ICP 1M recovers the transform")
    out["icp_1m_iterations"] = int(res.n_iters)

    a = jnp.asarray(rng.normal(size=(KERNEL_BIG_ROWS, 352)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(KERNEL_BIG_ROWS, 352)).astype(np.float32))
    stage("lowe_100k_x_100k_352",
          lambda: lowe_matching(a, b, verbose=False)[0])
    log("scale phase: " + json.dumps({k: round(v, 4) if isinstance(v, float)
                                      else v for k, v in out.items()}))


def four_phase(rng, work):
    """The sharded CLI path over four cards against one card."""
    import jax

    n = len(jax.devices())
    check(n >= 4, f"{n} visible GPUs >= 4")
    log("== four-card phase (CLI --n_devices 4 vs 1) ==")
    runs = []
    for mode, extra in (("staged", []), ("fused", ["--fused"])):
        for n_dev in ("1", "4"):
            argv = ["--descriptor_choice", "shot_single_scale",
                    "--n_devices", n_dev] + extra
            runs += [(f"{mode}_n{n_dev}", argv), (f"{mode}_n{n_dev}_warm", argv)]
    _, res = pair_phase(rng, work, runs)
    for mode in ("staged", "fused"):
        one, four = res[f"{mode}_n1"], res[f"{mode}_n4"]
        r_diff = rotation_error(four["matrix"][:3, :3], one["matrix"][:3, :3])
        check(r_diff < 1e-4, f"{mode}: 4 vs 1 card rotation {r_diff:.2e} < 1e-4 rad")
        m1 = [s["matches"] for s in one["m"]["stages"] if "matches" in s]
        m4 = [s["matches"] for s in four["m"]["stages"] if "matches" in s]
        check(len(m1) == len(m4) == 1 and abs(m4[0] - m1[0]) <= 0.01 * m1[0],
              f"{mode}: match count {m4} within 1% of {m1}")
        log(f"{mode}: cold 1 card {one['wall']:.3f} s, 4 cards "
            f"{four['wall']:.3f} s; warm 1 card {res[mode + '_n1_warm']['wall']:.3f}"
            f" s, 4 cards {res[mode + '_n4_warm']['wall']:.3f} s")
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded CLI path and its "
                         "one-card comparison")
    args = ap.parse_args()

    dev = require_gpu()
    import jax

    import shot_fpfh_tpu  # noqa: F401  (fails outside a checkout)

    log(f"device: {dev.device_kind}, {len(jax.devices())} visible; "
        f"card: {card_line()}")
    from shot_fpfh_tpu.utils.perf import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four:
            count = four_phase(rng, work)
        else:
            t0 = time.perf_counter()
            kernel_phase(rng, dev)
            pair_phase(rng, work)
            numerics_phase(rng)
            scale_phase(rng, dev)
            count = len(jax.devices())
            log(f"all phases: {time.perf_counter() - t0:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
