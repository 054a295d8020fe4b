"""Upload-cache behavior: content-keyed reuse, mutation safety, eviction."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from shot_fpfh_tpu.utils import device_cache as dc


@pytest.fixture(autouse=True)
def _clean_cache():
    dc.clear_upload_cache()
    yield
    dc.clear_upload_cache()


def _big(seed=0, n=300_000):
    # > _MIN_BYTES (1 MB) so the cache engages
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def test_repeat_upload_returns_same_buffer():
    a = _big()
    b1 = dc.to_device_cached(a)
    b2 = dc.to_device_cached(a)
    assert b1 is b2
    assert dc.upload_cache_stats()["entries"] == 1
    np.testing.assert_array_equal(np.asarray(b1), a)


def test_equal_content_different_object_hits():
    a = _big()
    b1 = dc.to_device_cached(a)
    b2 = dc.to_device_cached(a.copy())
    assert b1 is b2


def test_mutation_misses():
    a = _big()
    b1 = dc.to_device_cached(a)
    a[0, 0] += 1.0
    b2 = dc.to_device_cached(a)
    assert b1 is not b2
    assert float(np.asarray(b2)[0, 0]) == pytest.approx(float(a[0, 0]))


def test_small_arrays_bypass():
    a = np.ones((8, 3), np.float32)
    dc.to_device_cached(a)
    assert dc.upload_cache_stats()["entries"] == 0


def test_device_array_passthrough():
    d = jnp.ones((4, 3), jnp.float32)
    assert dc.to_device_cached(d) is d
    # dtype cast still happens
    assert dc.to_device_cached(d, jnp.bfloat16).dtype == jnp.bfloat16


def test_eviction_under_byte_budget(monkeypatch):
    monkeypatch.setattr(dc, "_MAX_BYTES", int(2.5 * _big().nbytes))
    b1 = dc.to_device_cached(_big(1))
    b2 = dc.to_device_cached(_big(2))
    b3 = dc.to_device_cached(_big(3))  # evicts the LRU entry (seed 1)
    assert dc.upload_cache_stats()["entries"] == 2
    assert dc.to_device_cached(_big(2)) is b2
    assert dc.to_device_cached(_big(3)) is b3
    assert dc.to_device_cached(_big(1)) is not b1  # was evicted -> fresh upload


def test_entry_cap(monkeypatch):
    monkeypatch.setattr(dc, "_MAX_ENTRIES", 2)
    dc.to_device_cached(_big(1))
    dc.to_device_cached(_big(2))
    dc.to_device_cached(_big(3))
    assert dc.upload_cache_stats()["entries"] == 2


def test_grid_subsample_prefix_download_semantics():
    # the slimmed wrapper (count + prefix slice) must match mask compression
    from shot_fpfh_tpu.core.subsampling import grid_subsample, grid_subsample_masked

    pts = np.random.default_rng(0).uniform(0, 4, size=(5_000, 3)).astype(np.float32)
    idx, mask = grid_subsample_masked(jnp.asarray(pts), 0.5)
    expected = np.asarray(idx)[np.asarray(mask)]
    np.testing.assert_array_equal(grid_subsample(pts, 0.5), expected)


def test_icp_wrapper_uses_cache():
    from shot_fpfh_tpu.core.transform import RigidTransform
    from shot_fpfh_tpu.registration.icp import icp_point_to_point

    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 8, size=(120_000, 3)).astype(np.float32)
    scan = ref + rng.normal(scale=1e-3, size=ref.shape).astype(np.float32)
    res1 = icp_point_to_point(scan, ref, RigidTransform.identity(), d_max=0.3,
                              voxel_size=0.8, max_iter=3)
    n_entries = dc.upload_cache_stats()["entries"]
    assert n_entries >= 2  # scan + ref retained
    res2 = icp_point_to_point(scan, ref, RigidTransform.identity(), d_max=0.3,
                              voxel_size=0.8, max_iter=3)
    assert dc.upload_cache_stats()["entries"] == n_entries  # pure hits
    assert res1.rms == pytest.approx(res2.rms)


def test_cache_is_keyed_on_the_target_device():
    """The same bytes uploaded under two default devices give two buffers,
    each on its own device (a process may run one cloud on two backends)."""
    a = _big()
    d0, d1 = jax.devices()[:2]
    with jax.default_device(d0):
        b0 = dc.to_device_cached(a)
    with jax.default_device(d1):
        b1 = dc.to_device_cached(a)
    assert b0.devices() == {d0} and b1.devices() == {d1}
    assert dc.upload_cache_stats()["entries"] == 2
