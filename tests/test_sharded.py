"""Multi-device tests on the 8-way virtual CPU mesh: every sharded stage must
agree with its single-device counterpart."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from shot_fpfh_tpu.core import RigidTransform, rotation_angle
from shot_fpfh_tpu.models import compute_normals, compute_shot_descriptor
from shot_fpfh_tpu.parallel import (
    make_mesh,
    ring_match,
    sharded_icp,
    sharded_ransac,
    sharded_shot_descriptors,
)
from tests.test_pipeline import bumpy_cloud, make_pair


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh()


def test_sharded_shot_matches_single_device(mesh):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    normals = rng.normal(size=(400, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    kp = pts[:50]

    single, _ = compute_shot_descriptor(
        kp, pts, normals, 1.5, k_max=128, min_neighborhood_size=5
    )
    multi = sharded_shot_descriptors(
        kp, pts, normals, 1.5, mesh, k_max=128, min_neighborhood_size=5
    )
    np.testing.assert_allclose(multi, np.asarray(single), atol=1e-4)


def test_sharded_shot_nondivisible_keypoints(mesh):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    normals = np.ones((300, 3), np.float32) / np.sqrt(3)
    kp = pts[:13]  # not a multiple of 8
    multi = sharded_shot_descriptors(
        kp, pts, normals, 1.5, mesh, k_max=64, min_neighborhood_size=3
    )
    assert multi.shape == (13, 352)


def test_ring_match_equals_bruteforce(mesh):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    a = rng.normal(size=(37, 16)).astype(np.float32)
    b = rng.normal(size=(53, 16)).astype(np.float32)
    res = ring_match(a, b, mesh)
    # the ring matcher shares the single-device matcher's bf16 operand
    # convention (distances between the ROUNDED descriptors, f32 acc), so the
    # oracle compares against the bf16-rounded inputs exactly and against the
    # raw f32 inputs within bf16 quantization noise
    a_r = np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float64)
    b_r = np.asarray(jnp.asarray(b).astype(jnp.bfloat16), np.float64)
    d = np.linalg.norm(a_r[:, None] - b_r[None], axis=-1)
    np.testing.assert_array_equal(res.idx, d.argmin(axis=1))
    np.testing.assert_allclose(res.d1, d.min(axis=1), atol=1e-4)
    d_sorted = np.sort(d, axis=1)
    np.testing.assert_allclose(res.d2, d_sorted[:, 1], atol=1e-4)
    d_raw = np.linalg.norm(a.astype(np.float64)[:, None] - b[None], axis=-1)
    np.testing.assert_allclose(res.d1, d_raw.min(axis=1), rtol=5e-3)


def test_sharded_ransac_recovers_transform(mesh):
    rng = np.random.default_rng(3)
    from tests.test_ransac_icp import ground_truth

    rot, t = ground_truth(rng)
    scan = rng.normal(size=(150, 3)).astype(np.float32)
    ref = (scan @ rot.T + t).astype(np.float32)
    bad = rng.choice(150, 75, replace=False)
    ref_noisy = ref.copy()
    ref_noisy[bad] += rng.normal(size=(75, 3)) * 4
    ratio, tf = sharded_ransac(
        scan, ref_noisy, jax.random.key(72), mesh,
        n_draws=1024, draw_size=4, distance_threshold=0.1,
    )
    assert float(rotation_angle(tf.rotation, jnp.asarray(rot))) < 0.05
    assert 0.3 < ratio <= 0.6


def test_sharded_icp_matches_ground_truth(mesh):
    rng = np.random.default_rng(4)
    scan, ref, exact = make_pair(rng, n=1500)
    ref_n = np.asarray(compute_normals(ref, ref, k=15))
    from shot_fpfh_tpu.core import grid_subsample

    sub = grid_subsample(scan.astype(np.float32), 0.15)
    tf, rms, conv, n_iters = sharded_icp(
        np.asarray(scan, np.float32)[sub], ref.astype(np.float32), ref_n,
        RigidTransform.identity(), mesh,
        d_max=1.0, max_iter=40, rms_threshold=1e-4, point_to_plane=True,
    )
    ang = float(rotation_angle(tf.rotation, exact.rotation))
    assert ang < 0.05, f"sharded ICP err {np.degrees(ang):.2f} deg"


def test_sharded_icp_point_to_point(mesh):
    rng = np.random.default_rng(9)
    ref = bumpy_cloud(1200, rng).astype(np.float32)
    tf, rms, conv, n_iters = sharded_icp(
        ref[::3], ref, None, RigidTransform.identity(), mesh,
        d_max=0.5, max_iter=20, rms_threshold=1e-3, point_to_plane=False,
    )
    assert conv
    np.testing.assert_allclose(np.asarray(tf.rotation), np.eye(3), atol=1e-3)


def test_multihost_helpers_single_process(mesh):
    """Single-process behavior of the multi-host helpers."""
    from shot_fpfh_tpu.parallel import (
        global_keypoint_array,
        host_local_keypoint_shard,
        initialize_distributed,
    )

    initialize_distributed()  # no-op for 1 process
    kp = np.arange(48, dtype=np.float32).reshape(16, 3)
    local = host_local_keypoint_shard(kp)
    np.testing.assert_array_equal(local, kp)  # 1 process owns everything
    arr = global_keypoint_array(local, mesh)
    assert arr.shape == (16, 3)
    np.testing.assert_array_equal(np.asarray(arr), kp)


@pytest.mark.slow
def test_scaling_report_runs(mesh):
    from shot_fpfh_tpu.parallel import scaling_report

    res = scaling_report(
        n_keypoints=64, n_support=2000, radius=1.0, k_max=32,
        device_counts=(1, 0),
    )
    assert 1 in res and 8 in res
    assert res[8] > 0 and res[1] > 0


def test_sharded_shot_grid_path_matches_single_device(mesh):
    rng = np.random.default_rng(9)
    pts = (rng.normal(size=(500, 3)) * 2.0).astype(np.float32)
    normals = rng.normal(size=(500, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    kp = pts[:50]
    sharded = sharded_shot_descriptors(
        kp, pts, normals, 0.8, mesh, k_max=128,
        min_neighborhood_size=3, use_grid=True,
    )
    # the grid path computes EXACT uncapped neighborhoods (grouped-window,
    # no top-k) — compare against the brute path with an ample cap
    single, _ = compute_shot_descriptor(
        kp, pts, normals, 0.8, k_max=500, min_neighborhood_size=3)
    np.testing.assert_allclose(sharded, np.asarray(single), atol=2e-3)


def test_scaling_report_fpfh_and_matching_run(mesh):
    from shot_fpfh_tpu.parallel import scaling_report

    for stage in ("fpfh", "matching"):
        res = scaling_report(
            n_keypoints=64, n_support=2000, radius=1.0, k_max=32,
            device_counts=(0,), stage=stage, reps=1,
        )
        assert res[8] > 0


@pytest.mark.gpu
def test_scaling_efficiency_target_on_hardware():
    """BASELINE north-star: >=80% scaling efficiency on real cards.  Runs
    whenever a multi-GPU host is attached; the virtual CPU mesh shares cores
    so the number is meaningless there (skipped)."""
    if len(jax.devices()) < 2:
        pytest.skip("scaling efficiency needs >= 2 GPUs")
    from shot_fpfh_tpu.parallel import scaling_report

    res = scaling_report(
        n_keypoints=8192, n_support=50000, radius=0.9, k_max=128,
        device_counts=(1, 0), stage="shot",
    )
    assert res["efficiency"] >= 0.8, f"scaling efficiency {res['efficiency']:.0%}"


def test_sharded_multiscale_match_parity(mesh):
    """8-device multiscale matching == single-device multiscale_top1 (same
    running-min kernel, reciprocal column argmin combined via all_gather) —
    VERDICT r2 next #3."""
    from shot_fpfh_tpu.parallel.sharded import sharded_multiscale_match
    from shot_fpfh_tpu.registration.matching import multiscale_top1

    rng = np.random.default_rng(11)
    scan_ms = rng.normal(size=(2, 83, 16)).astype(np.float32)  # 83: not /8
    ref_ms = rng.normal(size=(2, 97, 16)).astype(np.float32)
    scan_ms[0, :7] = 0.0
    ref_ms[1, 10:25] = 0.0
    for reciprocal in (False, True):
        idx_s, dist_s = sharded_multiscale_match(
            scan_ms, ref_ms, mesh, filter_nonreciprocal=reciprocal
        )
        idx_1, dist_1 = multiscale_top1(
            jnp.asarray(scan_ms), jnp.asarray(ref_ms),
            filter_nonreciprocal=reciprocal,
        )
        np.testing.assert_array_equal(idx_s, np.asarray(idx_1))
        np.testing.assert_allclose(dist_s, np.asarray(dist_1), atol=1e-5)


def test_match_descriptors_multiscale_mesh_route(mesh):
    """match_descriptors routes the multiscale branch through the mesh and
    agrees with the single-device result."""
    from shot_fpfh_tpu.registration import match_descriptors

    rng = np.random.default_rng(12)
    ref = rng.normal(size=(64, 16)).astype(np.float32)
    pick = rng.choice(64, 40, replace=False)
    scan = ref[pick] + 0.01 * rng.normal(size=(40, 16)).astype(np.float32)
    scan_ms = np.stack([scan, scan])
    ref_ms = np.stack([ref, ref])
    si_m, ri_m = match_descriptors(scan_ms, ref_ms, verbose=False, mesh=mesh)
    si_1, ri_1 = match_descriptors(scan_ms, ref_ms, verbose=False)
    np.testing.assert_array_equal(si_m, si_1)
    np.testing.assert_array_equal(ri_m, ri_1)


@pytest.mark.slow
def test_sharded_icp_grid_parity_large_ref(mesh):
    """Above AUTO_GRID_MIN_POINTS the sharded ICP dispatches through the
    replicated grid-hash 1-NN (VERDICT r2 next #4) and agrees with the
    single-device grid path."""
    from shot_fpfh_tpu.registration.icp import icp_point_to_plane

    rng = np.random.default_rng(17)
    xy = rng.uniform(-4, 4, size=(24_000, 2))
    ref = np.column_stack(
        [xy, 0.5 * np.sin(1.7 * xy[:, 0]) * np.cos(1.1 * xy[:, 1])]
    ).astype(np.float32)
    ref_n = np.asarray(compute_normals(ref, ref, k=12))
    ang = 0.04
    R = np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
        np.float32,
    )
    scan = (ref @ R.T + np.array([0.05, -0.03, 0.01], np.float32))[::5]

    single = icp_point_to_plane(
        scan, ref, ref_n, RigidTransform.identity(),
        d_max=0.5, voxel_size=0.25, max_iter=12, rms_threshold=1e-5,
    )
    from shot_fpfh_tpu.core import grid_subsample

    sub = grid_subsample(scan, 0.25)
    tf, rms, conv, n_iters = sharded_icp(
        scan[sub], ref, ref_n, RigidTransform.identity(), mesh,
        d_max=0.5, max_iter=12, rms_threshold=1e-5, point_to_plane=True,
    )
    ang_diff = float(rotation_angle(tf.rotation, single.transform.rotation))
    assert ang_diff < 1e-3, f"sharded-vs-single grid ICP diverged: {ang_diff}"
    np.testing.assert_allclose(
        np.asarray(tf.translation), np.asarray(single.transform.translation),
        atol=5e-3,
    )
    assert n_iters == single.n_iters
