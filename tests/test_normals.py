import numpy as np
import pytest
import jax.numpy as jnp

from shot_fpfh_tpu.models import (
    compute_normals,
    compute_pca_based_basic_features,
    compute_pca_based_features,
    compute_sphericity,
)


def numpy_normals_knn(queries, cloud, k):
    out = np.zeros((len(queries), 3))
    for i, q in enumerate(queries):
        d = np.linalg.norm(cloud - q, axis=1)
        nb = cloud[np.argsort(d)[:k]]
        c = nb - nb.mean(axis=0)
        cov = c.T @ c / len(nb)
        _, vec = np.linalg.eigh(cov)
        out[i] = vec[:, 0]
    return out


def test_normals_match_numpy_oracle(rng, surface_cloud):
    pts = surface_cloud.astype(np.float32)
    q = pts[:80]
    ours = np.asarray(compute_normals(q, pts, k=20))
    oracle = numpy_normals_knn(q, pts, 20)
    # normals defined up to sign
    dots = np.abs(np.sum(ours * oracle, axis=1))
    assert (dots > 0.99).mean() > 0.95


def test_normals_unit_length(surface_cloud):
    pts = surface_cloud.astype(np.float32)
    n = np.asarray(compute_normals(pts[:50], pts, k=15))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)


def test_normals_reorientation(surface_cloud):
    pts = surface_cloud.astype(np.float32)
    pre = np.tile([0.0, 0.0, 1.0], (60, 1)).astype(np.float32)
    n = np.asarray(compute_normals(pts[:60], pts, k=20, pre_computed_normals=pre))
    assert (n[:, 2] >= 0).all()


def test_normals_radius_mode(surface_cloud):
    pts = surface_cloud.astype(np.float32)
    n = np.asarray(compute_normals(pts[:40], pts, radius=0.3, k_max=128))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)


def test_sphericity_flat_vs_blob(rng):
    flat = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    flat[:, 2] *= 0.001
    blob = rng.normal(size=(300, 3)).astype(np.float32)
    s_flat = np.asarray(compute_sphericity(flat[:20], flat, 1.0, k_max=256))
    s_blob = np.asarray(compute_sphericity(blob[:20], blob, 2.0, k_max=256))
    assert s_flat.mean() < 0.01
    assert s_blob.mean() > 0.1


def test_basic_features_shapes_and_ranges(surface_cloud):
    pts = surface_cloud.astype(np.float32)
    vert, lin, plan, sph = compute_pca_based_basic_features(pts[:30], pts, 0.4, k_max=128)
    for f in (vert, lin, plan, sph):
        assert f.shape == (30,)
        v = np.asarray(f)
        assert (v >= -1e-4).all() and (v <= 1.0 + 1e-4).all()


def test_full_features_shape(surface_cloud):
    pts = surface_cloud.astype(np.float32)
    feats = np.asarray(compute_pca_based_features(pts[:25], pts, 0.4, k_max=128))
    assert feats.shape == (25, 21)
    assert np.isfinite(feats).all()


def test_normals_radius_grid_branch(monkeypatch, rng):
    """compute_normals' large-cloud radius branch (fused grid PCA) must match
    the brute radius path."""
    import shot_fpfh_tpu.models.normals as nm

    # a smooth sheet: surface normals are well-conditioned (a Gaussian blob
    # has near-isotropic neighborhoods where the smallest eigenvector is
    # ill-defined and the two paths may legitimately disagree)
    xy = rng.uniform(-2, 2, size=(400, 2))
    z = 0.4 * np.sin(1.3 * xy[:, 0]) * np.cos(1.1 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    dense = np.asarray(nm.compute_normals(pts[:50], pts, radius=0.9, k_max=400))
    monkeypatch.setattr(nm, "AUTO_GRID_MIN_POINTS", 10)
    fused = np.asarray(nm.compute_normals(pts[:50], pts, radius=0.9))
    # normals defined up to sign
    dots = np.abs(np.sum(dense * fused, axis=1))
    assert np.all(dots > 1 - 1e-4)


@pytest.mark.slow
def test_pca_features_grid_path_matches_brute(rng):
    """Above the auto-grid threshold the PCA feature functions switch to
    grid/window formulations; they must agree with the brute path."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.models.normals import (
        _pca_moments_brute,
        _sphericity_brute,
        compute_pca_based_features,
        compute_sphericity,
        local_pca_with_moments,
    )
    from shot_fpfh_tpu.ops import grid_hash

    n = grid_hash.AUTO_GRID_MIN_POINTS + 500
    xy = rng.uniform(-9, 9, size=(n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(1.3 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    q = pts[:256]
    radius = 0.5

    sph_g = np.asarray(compute_sphericity(q, pts, radius))
    sph_b = np.asarray(_sphericity_brute(
        jnp.asarray(q), jnp.asarray(pts), radius, 256))
    np.testing.assert_allclose(sph_g, sph_b, atol=1e-4)

    w_g, v_g, mom_g, sz_g = local_pca_with_moments(q, pts, radius)
    w_b, v_b, mom_b, sz_b = _pca_moments_brute(
        jnp.asarray(q), jnp.asarray(pts), radius, 256)
    np.testing.assert_array_equal(np.asarray(sz_g), np.asarray(sz_b))
    np.testing.assert_allclose(np.asarray(w_g), np.asarray(w_b), atol=1e-4)
    np.testing.assert_allclose(np.asarray(mom_g), np.asarray(mom_b), atol=1e-3)

    feats = np.asarray(compute_pca_based_features(q, pts, radius))
    assert feats.shape == (256, 21)
    assert np.isfinite(feats).all()


def test_pca_features_verbose_plots_sizes(rng, caplog, tmp_path, monkeypatch):
    """verbose=True routes through plot_neighborhood_sizes (reference
    pca_based_descriptors.py:105-119) and logs the stats."""
    import logging

    from shot_fpfh_tpu.models.normals import compute_pca_based_features

    monkeypatch.chdir(tmp_path)  # the plot lands in cwd, not the repo
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    with caplog.at_level(logging.INFO):
        feats = compute_pca_based_features(pts[:40], pts, 0.8, verbose=True)
    assert feats.shape == (40, 21)
    assert any("Average size of neighborhoods" in r.message for r in caplog.records)


def test_plot_neighborhood_sizes_returns_histogram(rng, tmp_path):
    from shot_fpfh_tpu.analysis import plot_neighborhood_sizes

    sizes = rng.integers(5, 60, size=300)
    counts, edges = plot_neighborhood_sizes(
        sizes, output_path=str(tmp_path / "h.png")
    )
    assert counts.sum() == 300
    assert len(edges) == len(counts) + 1


def test_grid_radius_pca_vector_radius(rng):
    """Per-query radius vector: each row must equal a scalar-radius call."""
    from shot_fpfh_tpu.ops.grid_hash import build_grid, grid_radius_pca

    xy = rng.uniform(-3, 3, size=(2000, 2))
    z = 0.3 * np.sin(1.2 * xy[:, 0]) * np.cos(0.8 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    grid = build_grid(pts, 0.8)
    q = jnp.asarray(pts[:64])
    radii = np.asarray(rng.uniform(0.2, 0.8, size=64), np.float32)
    cov_v, bary_v, cnt_v = grid_radius_pca(grid, q, radii)
    for r in np.unique(np.round(radii, 2))[:4]:
        rows = np.nonzero(np.round(radii, 2) == r)[0]
        cov_s, bary_s, cnt_s = grid_radius_pca(grid, q, float(radii[rows[0]]))
        np.testing.assert_array_equal(
            np.asarray(cnt_v)[rows], np.asarray(cnt_s)[rows]
        )
        np.testing.assert_allclose(
            np.asarray(cov_v)[rows], np.asarray(cov_s)[rows], atol=1e-6
        )


@pytest.mark.slow
def test_streaming_knn_normals_matches_exact(monkeypatch, rng):
    """The large-cloud k-mode route (streaming covariance with k-targeting
    adaptive radii, VERDICT r3 #3) must agree with exact k-NN PCA normals up
    to the documented neighborhood-superset deviation."""
    import shot_fpfh_tpu.models.normals as nm

    xy = rng.uniform(-6, 6, size=(8000, 2))
    z = 0.5 * np.sin(1.1 * xy[:, 0]) * np.cos(0.9 * xy[:, 1])
    pts = (np.column_stack([xy, z])
           + rng.normal(scale=0.01, size=(8000, 3))).astype(np.float32)
    q = pts[:512]
    exact = np.asarray(nm._normals_knn(jnp.asarray(q), jnp.asarray(pts), 20, None))
    monkeypatch.setattr(nm, "AUTO_GRID_MIN_POINTS", 1000)
    ours = np.asarray(nm.compute_normals(q, pts, k=20))
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-4)
    dots = np.abs(np.sum(ours * exact, axis=1))
    assert dots.mean() > 0.998 and np.quantile(dots, 0.02) > 0.98, dots.min()


@pytest.mark.slow
def test_streaming_knn_normals_net_catches_sparse(rng):
    """Queries in regions the density calibration under-covers must be
    re-solved exactly (count < k -> brute k-NN), keeping the k-NN contract."""
    import shot_fpfh_tpu.models.normals as nm

    # dense sheet + a handful of far-flung sparse points: the calibration
    # fits the dense sheet, so sparse-region queries under-cover
    xy = rng.uniform(-2, 2, size=(4000, 2))
    dense = np.column_stack([xy, 0.1 * np.sin(xy[:, 0])]).astype(np.float32)
    sparse = rng.uniform(8, 12, size=(40, 3)).astype(np.float32)
    pts = np.concatenate([dense, sparse]).astype(np.float32)
    q = np.concatenate([dense[:100], sparse[:20]])
    ours = np.asarray(nm._streaming_knn_normals(
        jnp.asarray(q), jnp.asarray(pts), 15, None
    ))
    exact = np.asarray(nm._normals_knn(jnp.asarray(q), jnp.asarray(pts), 15, None))
    # sparse-region rows went through the exact net: identical up to sign
    dots = np.abs(np.sum(ours[100:] * exact[100:], axis=1))
    assert np.all(dots > 1 - 1e-4), dots.min()


def test_kth_distance_bound_exact_far_from_origin(rng):
    """The k-th-neighbor bound is exact to the f32 rounding of the distance
    itself, also for a cloud far from the origin, where the matmul expansion
    ‖a‖² + ‖b‖² − 2a·b cancels most of its digits."""
    from shot_fpfh_tpu.ops.grid_hash import kth_distance_bound

    pts = (rng.uniform(-4, 4, size=(3000, 3)) * [1.0, 1.0, 0.1]
           + [60.0, -40.0, 10.0]).astype(np.float32)
    sample = pts[::30][:100]
    got = np.asarray(kth_distance_bound(jnp.asarray(sample), jnp.asarray(pts), 12))
    d = np.linalg.norm(sample[:, None].astype(np.float64) - pts[None], axis=-1)
    np.testing.assert_allclose(got, np.sort(d, axis=1)[:, 11], rtol=1e-6)


def test_streaming_normals_independent_of_kth_rounding(monkeypatch, rng):
    """The streaming normals calibrate every query's radius from the sampled
    k-th-neighbor bound, and a point moves in or out of a radius on the
    smallest change to it.  With the bound exact to f32 rounding, a float64
    bound changes no normal, so the backend's rounding does not either."""
    import shot_fpfh_tpu.models.normals as nm
    from shot_fpfh_tpu.ops import grid_hash

    xy = rng.uniform(-5, 5, size=(8000, 2))
    z = 0.6 * np.sin(1.1 * xy[:, 0]) * np.cos(0.9 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    monkeypatch.setattr(nm, "AUTO_GRID_MIN_POINTS", 1000)
    ours = np.asarray(nm.compute_normals(pts, pts, k=30), np.float64)

    def kth64(sample, points, k):
        d2 = np.sum((np.asarray(sample, np.float64)[:, None]
                     - np.asarray(points, np.float64)[None]) ** 2, axis=-1)
        return jnp.asarray(np.sqrt(np.sort(d2, axis=1)[:, k - 1]), jnp.float32)

    monkeypatch.setattr(grid_hash, "kth_distance_bound", kth64)
    ref = np.asarray(nm.compute_normals(pts + 0.0, pts + 0.0, k=30), np.float64)
    sign = np.where(np.sum(ours * ref, axis=1, keepdims=True) < 0, -1.0, 1.0)
    assert np.abs(ours - sign * ref).max() <= 1e-6
