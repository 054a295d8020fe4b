import pytest
import numpy as np
import jax.numpy as jnp

from shot_fpfh_tpu.ops.grid_hash import (
    build_grid,
    grid_nearest_neighbor,
    grid_radius_search,
    radius_search_auto,
)
from shot_fpfh_tpu.ops.neighbors import radius_search


def clouds(rng, n=3000, scale=4.0):
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    return pts


def test_grid_matches_bruteforce(rng):
    pts = clouds(rng)
    q = pts[:200]
    radius = 0.5
    brute = radius_search(jnp.asarray(q), jnp.asarray(pts), radius, 64)
    grid = build_grid(pts, radius)
    ours = grid_radius_search(grid, jnp.asarray(q), radius, 64)
    # same neighbor sets (sort indices within each row)
    for i in range(200):
        b = set(np.asarray(brute.idx[i])[np.asarray(brute.mask[i])])
        g = set(np.asarray(ours.idx[i])[np.asarray(ours.mask[i])])
        assert b == g, f"row {i}: {b ^ g}"
    np.testing.assert_allclose(
        np.sort(np.asarray(ours.dist), axis=1),
        np.sort(np.asarray(brute.dist), axis=1),
        atol=1e-5,
    )


def test_grid_dense_cell(rng):
    # many coincident points in one cell: cell_cap must cover them
    pts = np.vstack([
        rng.normal(scale=0.01, size=(500, 3)),
        rng.uniform(-3, 3, size=(500, 3)),
    ]).astype(np.float32)
    grid = build_grid(pts, 0.4)
    assert grid.cell_cap >= 500
    res = grid_radius_search(grid, jnp.asarray(pts[:5]), 0.4, 600)
    brute = radius_search(jnp.asarray(pts[:5]), jnp.asarray(pts), 0.4, 600)
    np.testing.assert_array_equal(
        np.asarray(res.mask).sum(1), np.asarray(brute.mask).sum(1)
    )


def test_grid_queries_outside_cloud(rng):
    pts = clouds(rng, n=1000)
    far = np.array([[50.0, 50.0, 50.0], [-50.0, 0.0, 0.0]], np.float32)
    grid = build_grid(pts, 0.5)
    res = grid_radius_search(grid, jnp.asarray(far), 0.5, 32)
    assert np.asarray(res.mask).sum() == 0


def test_grid_nearest_neighbor(rng):
    pts = clouds(rng, n=2000)
    q = pts[:300] + rng.normal(scale=0.05, size=(300, 3)).astype(np.float32)
    grid = build_grid(pts, 0.5)
    dist, idx = grid_nearest_neighbor(grid, jnp.asarray(q))
    d = np.linalg.norm(q[:, None] - pts[None], axis=-1)
    # exact whenever the true NN is within the cell neighborhood
    expected = d.min(axis=1)
    ours = np.asarray(dist)
    close = expected <= 0.5
    np.testing.assert_allclose(ours[close], expected[close], atol=1e-5)


def test_radius_search_auto_dispatch(rng):
    pts = clouds(rng, n=500)
    res = radius_search_auto(pts[:20], pts, 0.5, 32)
    brute = radius_search(jnp.asarray(pts[:20]), jnp.asarray(pts), 0.5, 32)
    np.testing.assert_array_equal(np.asarray(res.mask), np.asarray(brute.mask))


def test_grid_shot_descriptors_match_brute(rng):
    """SHOT computed from grid-hash neighborhoods == brute-force neighborhoods."""
    from shot_fpfh_tpu.models.shot import local_reference_frames, shot_from_neighborhoods

    pts = clouds(rng, n=2500, scale=2.0)
    normals = rng.normal(size=(2500, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    kp = pts[:40]
    radius = 0.8

    def descriptors(nbr):
        rfs = local_reference_frames(jnp.asarray(kp), jnp.asarray(pts)[nbr.idx], nbr.mask, radius)
        return shot_from_neighborhoods(
            jnp.asarray(kp), jnp.asarray(pts)[nbr.idx], jnp.asarray(normals)[nbr.idx],
            nbr.mask, rfs, radius, normalize=True, min_neighborhood_size=5,
        )

    brute = descriptors(radius_search(jnp.asarray(kp), jnp.asarray(pts), radius, 128))
    grid = descriptors(grid_radius_search(build_grid(pts, radius), jnp.asarray(kp), radius, 128))
    np.testing.assert_allclose(np.asarray(brute), np.asarray(grid), atol=1e-4)


def test_grid_with_values_matches_gather(rng):
    import numpy as np
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 2.0
    extras = rng.normal(size=(300, 3)).astype(np.float32)
    q = pts[:40]
    grid = build_grid(pts, 0.7, extras=extras)
    nbr, vals = grid_radius_search(grid, jnp.asarray(q), 0.7, 48, with_values=True)
    m = np.asarray(nbr.mask)
    got_pts = np.asarray(vals[..., :3])
    got_ext = np.asarray(vals[..., 3:6])
    want_pts = np.where(m[..., None], pts[np.asarray(nbr.idx)], 0.0)
    want_ext = np.where(m[..., None], extras[np.asarray(nbr.idx)], 0.0)
    assert np.allclose(got_pts, want_pts, atol=1e-6)
    assert np.allclose(got_ext, want_ext, atol=1e-6)


def test_window_cap_bounds_every_query(rng):
    import numpy as np
    # clustered cloud: one dense blob + sparse background stresses the
    # window_cap bound (max 3x3x3 occupancy must cover blob-centered queries)
    blob = rng.normal(size=(400, 3)).astype(np.float32) * 0.1
    bg = rng.uniform(-4, 4, size=(200, 3)).astype(np.float32)
    pts = np.concatenate([blob, bg])
    grid = build_grid(pts, 0.5)
    # queries everywhere, including off-grid
    q = np.concatenate([pts[:50], np.array([[9.0, 9.0, 9.0]], np.float32)])
    res = grid_radius_search(grid, jnp.asarray(q), 0.5, 600)
    # oracle counts
    d = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
    want = (d <= 0.5).sum(axis=1)
    got = np.asarray(res.mask.sum(axis=-1))
    assert np.array_equal(got, want)


def test_grid_radius_pca_matches_bruteforce(rng):
    import numpy as np
    from shot_fpfh_tpu.ops.grid_hash import grid_radius_pca
    pts = (rng.normal(size=(500, 3)) * 2.0 + 100.0).astype(np.float32)  # offset
    q = pts[:30]
    radius = 0.9
    grid = build_grid(pts, radius)
    cov, bary, count = grid_radius_pca(grid, jnp.asarray(q), radius)
    d = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
    for i in range(len(q)):
        nb = pts[d[i] <= radius].astype(np.float64)
        assert int(count[i]) == len(nb)
        b = nb.mean(axis=0)
        c_ref = (nb - b).T @ (nb - b) / len(nb)
        assert np.allclose(np.asarray(bary[i]), b, atol=1e-4)
        assert np.allclose(np.asarray(cov[i]), c_ref, atol=1e-4)


def test_halo2_grid_matches_bruteforce(rng):
    import numpy as np
    pts = rng.normal(size=(400, 3)).astype(np.float32) * 2.0
    q = np.concatenate([pts[:30], np.array([[9.0, 9.0, 9.0]], np.float32)])
    radius = 0.8
    grid = build_grid(pts, radius / 2, halo=2)  # cell = r/2, 5^3 window
    res = grid_radius_search(grid, jnp.asarray(q), radius, 64)
    d = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
    want = (d <= radius).sum(axis=1)
    got = np.asarray(res.mask.sum(axis=-1))
    assert np.array_equal(got, want)
    da = np.sort(np.where(d <= radius, d, 1e9), axis=1)[:, :64]
    db = np.sort(np.where(np.asarray(res.mask), np.asarray(res.dist), 1e9), axis=1)
    assert np.allclose(np.minimum(da, 1e9), np.minimum(db, 1e9), atol=1e-5)


def test_radius_pca_tableless_fallback(rng):
    """Sparse grids without a cell-start table must still produce correct
    PCA moments (regression: the compacted path silently returned zeros)."""
    from shot_fpfh_tpu.ops.grid_hash import HashGrid, grid_radius_pca
    import shot_fpfh_tpu.ops.grid_hash as gh
    pts = rng.uniform(-500, 500, size=(300, 3)).astype(np.float32)
    radius = 2.0
    grid = build_grid(pts, radius)
    # force the no-table path regardless of what build chose
    grid = HashGrid(grid.packed_sorted, grid.orig_idx, grid.cell_ids_sorted,
                    grid.origin, grid.dims, grid.cell_size,
                    jnp.zeros((1,), jnp.int32), grid.cell_cap, False,
                    27 * grid.cell_cap, 1)
    q = pts[:20]
    cov, bary, cnt = grid_radius_pca(grid, jnp.asarray(q), radius)
    d = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
    want = (d <= radius).sum(axis=1)
    assert np.array_equal(np.asarray(cnt).astype(int), want)


def test_knn_auto_sparse_region_exactness(monkeypatch, rng):
    """knn_auto must honor the k-NN contract even for queries in sparse
    regions where the sampled radius bound under-covers (regression)."""
    import shot_fpfh_tpu.ops.grid_hash as gh
    blob = rng.normal(size=(800, 3)).astype(np.float32) * 0.2
    halo_pts = rng.uniform(-30, 30, size=(40, 3)).astype(np.float32)
    pts = np.concatenate([blob, halo_pts])
    monkeypatch.setattr(gh, "AUTO_GRID_MIN_POINTS", 100)
    k = 8
    nbr = gh.knn_auto(pts, pts, k)
    counts = np.asarray(nbr.mask.sum(axis=1))
    assert counts.min() == k  # every query gets its full k
    # spot-check distances against the oracle on the sparse points
    d = np.linalg.norm(pts[800:, None, :] - pts[None, :, :], axis=-1)
    want = np.sort(d, axis=1)[:, :k]
    got = np.sort(np.asarray(nbr.dist[800:]), axis=1)
    assert np.allclose(got, want, atol=1e-5)


def test_grouped_window_gather_fragmented_budget(rng):
    """Regression (round-2 review): the static group budget must cover
    fragmented windows where every run straddles a group boundary — the
    original window_cap//G + R bound silently dropped candidates."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.ops.grid_hash import build_grid, grouped_window_gather

    # small cells, few points per cell -> many short runs per window
    pts = (rng.uniform(0, 5, size=(197, 3))).astype(np.float32)
    radius = 1.0
    grid = build_grid(pts, radius, halo=1)
    vals, rows, valid = grouped_window_gather(grid, jnp.asarray(pts))
    d = np.linalg.norm(np.asarray(vals)[:, :3, :].transpose(0, 2, 1)
                       - pts[:, None, :], axis=-1)
    ok = np.asarray(valid) & (d <= radius)
    d_brute = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    found = ok.sum(axis=1)
    want = (d_brute <= radius).sum(axis=1)
    np.testing.assert_array_equal(found, want)


@pytest.mark.slow
def test_window_path_tableless_grid(rng):
    """Table-less (sparse) grids must produce EXACT windows through the
    grouped gather — previously every window came back silently empty, so
    the uncapped SHOT/FPFH/PCA/fused/sharded paths returned all-zero
    descriptors on large-extent sparse clouds (ADVICE r2 #1)."""
    from shot_fpfh_tpu.ops.grid_hash import (
        HashGrid, grid_nearest_neighbor, window_distances,
    )

    pts = rng.uniform(-400, 400, size=(257, 3)).astype(np.float32)
    radius = 3.0
    grid = build_grid(pts, radius)
    grid_nt = HashGrid(grid.packed_sorted, grid.orig_idx, grid.cell_ids_sorted,
                       grid.origin, grid.dims, grid.cell_size,
                       jnp.zeros((1,), jnp.int32), grid.cell_cap, False,
                       27 * grid.cell_cap, 1)
    q = pts[:32]
    _vals, dist, valid, rows = window_distances(grid_nt, jnp.asarray(q))
    got = (np.asarray(valid) & (np.asarray(dist) <= radius)).sum(axis=1)
    d = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
    np.testing.assert_array_equal(got, (d <= radius).sum(axis=1))
    # 1-NN through the same grid agrees with the oracle
    qq = q + rng.uniform(-0.5, 0.5, size=q.shape).astype(np.float32)
    best, idx = grid_nearest_neighbor(grid_nt, jnp.asarray(qq))
    want = np.linalg.norm(qq[:, None, :] - pts[None, :, :], axis=-1).min(axis=1)
    assert np.allclose(np.asarray(best), want, atol=1e-5)


def test_xyrow_mode_exact_on_surface(rng):
    """Surface-like clouds auto-select the xy-row run mode (5 full-z runs
    instead of 25 z-column runs, round-3 headline optimization) and the
    grouped window stays EXACT vs brute force."""
    from shot_fpfh_tpu.ops.grid_hash import window_distances

    xy = rng.uniform(-5, 5, size=(3000, 2))
    z = 0.4 * np.sin(1.3 * xy[:, 0]) * np.cos(0.9 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    radius = 0.8
    grid = build_grid(pts, radius / 2, halo=2)
    assert grid.use_xyrow, "flat surface should pick the xy-row mode"
    q = jnp.asarray(pts[:64])
    _v, d, ok, rows = window_distances(grid, q)
    got = (np.asarray(ok) & (np.asarray(d) <= radius)).sum(axis=1)
    brute = np.linalg.norm(pts[:64, None, :] - pts[None, :, :], axis=-1)
    np.testing.assert_array_equal(got, (brute <= radius).sum(axis=1))
    # no duplicate candidates within a window
    rows_np = np.asarray(rows)
    ok_np = np.asarray(ok)
    for i in range(0, 64, 7):
        rr = rows_np[i][ok_np[i]]
        assert len(rr) == len(np.unique(rr))


def test_xyrow_mode_rejected_for_volumetric(rng):
    """Deep volumetric clouds (tall z-columns) must stay on z-column runs —
    the full-z window would balloon the candidate width."""
    pts = rng.uniform(-3, 3, size=(5000, 3)).astype(np.float32)
    pts[:, 2] *= 3.0  # stretch z: columns get deep
    grid = build_grid(pts, 0.25, halo=2)
    # whether selected or not, the grouped path must stay exact
    from shot_fpfh_tpu.ops.grid_hash import window_distances

    q = jnp.asarray(pts[:32])
    _v, d, ok, _ = window_distances(grid, q)
    got = (np.asarray(ok) & (np.asarray(d) <= 0.5)).sum(axis=1)
    brute = np.linalg.norm(pts[:32, None, :] - pts[None, :, :], axis=-1)
    np.testing.assert_array_equal(got, (brute <= 0.5).sum(axis=1))


@pytest.mark.slow
def test_window_group_sizes_same_candidates(rng):
    """G=16/32 grouped fetches (xyrow exact caps, round 4) must return the
    same in-radius candidate set — wider groups only change the padding."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.ops.grid_hash import build_grid, window_distances

    xy = rng.uniform(-4, 4, size=(6000, 2))
    z = 0.4 * np.sin(1.2 * xy[:, 0]) * np.cos(xy[:, 1])
    pts = (np.column_stack([xy, z])
           + rng.normal(scale=0.01, size=(6000, 3))).astype(np.float32)
    grid = build_grid(pts, 0.45, halo=2)
    assert grid.xyrow_group_cap16 > 0 and grid.xyrow_group_cap32 > 0
    q = jnp.asarray(pts[:64])
    radius = 0.9
    ref_sets = None
    for g in (8, 16, 32):
        _vals, d, ok, rows = window_distances(grid, q, group=g)
        inr = np.asarray(ok & (d <= radius))
        rws = np.asarray(rows)
        sets = [np.sort(rws[i][inr[i]]) for i in range(64)]
        if ref_sets is None:
            ref_sets = sets
        else:
            assert all(np.array_equal(a, b) for a, b in zip(ref_sets, sets)), g


@pytest.mark.slow
def test_set_window_group_descriptor_invariant(rng):
    """SHOT descriptors must be invariant to the fetch's group size (the
    set_window_group A/B knob only changes padding lanes)."""
    import jax.numpy as jnp

    from shot_fpfh_tpu.models.shot import shot_from_window_ff
    from shot_fpfh_tpu.ops.grid_hash import (
        build_grid,
        set_window_group,
        window_distances,
    )

    xy = rng.uniform(-4, 4, size=(6000, 2))
    z = 0.4 * np.sin(1.2 * xy[:, 0]) * np.cos(xy[:, 1])
    pts = (np.column_stack([xy, z])
           + rng.normal(scale=0.01, size=(6000, 3))).astype(np.float32)
    nrm = rng.normal(size=(6000, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    grid = build_grid(pts, 0.45, extras=nrm, halo=2)
    q = jnp.asarray(pts[:64])
    radius = 0.9

    def desc():
        vals, d, ok, _ = window_distances(grid, q)
        dist_inf = jnp.where(ok & (d <= radius), d, jnp.inf)
        out, _ = shot_from_window_ff(q, vals, dist_inf, radius,
                                     normalize=True, min_neighborhood_size=5)
        return np.asarray(out)

    try:
        base = desc()
        for g in (16, 32):
            set_window_group(g)
            np.testing.assert_allclose(desc(), base, atol=2e-5)
    finally:
        set_window_group(0)


def test_grid_cache_hits_on_equal_content(rng):
    """build_grid returns the SAME object for byte-equal host inputs and a
    fresh grid once content, cell size, halo, or extras change."""
    from shot_fpfh_tpu.ops import grid_hash as gh

    pts = clouds(rng, n=500)
    ext = rng.normal(size=(500, 3)).astype(np.float32)
    gh.clear_grid_cache()
    g1 = build_grid(pts, 0.5, extras=ext, halo=2)
    g2 = build_grid(pts.copy(), 0.5, extras=ext.copy(), halo=2)  # equal bytes
    assert g2 is g1
    assert build_grid(pts, 0.4, extras=ext, halo=2) is not g1    # cell size
    assert build_grid(pts, 0.5, extras=ext, halo=1) is not g1    # halo
    assert build_grid(pts, 0.5, halo=2) is not g1                # extras off
    bumped = pts.copy()
    bumped[0, 0] += 1e-3
    assert build_grid(bumped, 0.5, extras=ext, halo=2) is not g1  # content
    # device-array inputs bypass the cache (no forced download)
    gj = build_grid(jnp.asarray(pts), 0.5, halo=2)
    assert build_grid(jnp.asarray(pts), 0.5, halo=2) is not gj
    gh.clear_grid_cache()


def test_grid_cache_lru_bound(rng):
    from shot_fpfh_tpu.ops import grid_hash as gh

    gh.clear_grid_cache()
    for i in range(gh._GRID_CACHE_MAX + 3):
        build_grid(clouds(rng, n=64), 0.5)
    assert len(gh._GRID_CACHE) <= gh._GRID_CACHE_MAX
    gh.clear_grid_cache()


def test_grid_cache_byte_budget(rng, monkeypatch):
    """The LRU also bounds retained device bytes (ADVICE r4): under a small
    byte budget older entries are evicted even when the entry count is under
    _GRID_CACHE_MAX, and the newest entry always survives."""
    from shot_fpfh_tpu.ops import grid_hash as gh

    gh.clear_grid_cache()
    one = gh._grid_nbytes(build_grid(clouds(rng, n=512), 0.5))
    gh.clear_grid_cache()
    monkeypatch.setattr(gh, "_GRID_CACHE_MAX_BYTES", int(2.5 * one))
    for _ in range(4):
        build_grid(clouds(rng, n=512), 0.5)
        assert gh.grid_cache_stats()["bytes"] <= int(2.5 * one)
    assert 1 <= gh.grid_cache_stats()["entries"] <= 2
    # an over-budget grid is never cached, and doesn't evict what's there
    monkeypatch.setattr(gh, "_GRID_CACHE_MAX_BYTES", one // 2)
    before = gh.grid_cache_stats()["entries"]
    build_grid(clouds(rng, n=512), 0.5)
    assert gh.grid_cache_stats()["entries"] <= before
    gh.clear_grid_cache()
