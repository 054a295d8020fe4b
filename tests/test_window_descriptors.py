"""XLA window descriptors vs the NumPy oracles.

The large-cloud SHOT and SPFH paths consume dense FEATURE-FIRST candidate
windows (``ops.grid_hash.window_distances``): ``shot_from_window_ff`` and
``models.fpfh.spfh_from_window``.  These cases check them against the
independent per-query NumPy re-derivations of the reference (SHOT 352-D,
FPFH 33-D decorrelated and 125-D joint), including empty neighborhoods,
sentinel-padded queries and the bi-scale frame plane.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from _windows import window_case
from test_shot import oracle_local_rf, oracle_shot
from shot_fpfh_tpu.models.fpfh import spfh_from_window
from shot_fpfh_tpu.models.shot import shot_from_window_ff

RADIUS = 0.8


def _members(vals_ff, dist_inf, i):
    ok = np.isfinite(dist_inf[i])
    return vals_ff[i, :3, ok].astype(np.float64), vals_ff[i, 3:6, ok]


def _shot(kp, vals_ff, dist_inf, min_size=5, **kw):
    desc, rfs = shot_from_window_ff(
        jnp.asarray(kp), jnp.asarray(vals_ff), jnp.asarray(dist_inf), RADIUS,
        min_neighborhood_size=min_size, **kw)
    return np.asarray(desc), np.asarray(rfs)


def _assert_frame(rf, kp_i, nb, radius):
    expected = oracle_local_rf(kp_i, nb, radius)
    # columns agree up to the sign votes' near-ties (f32 vs the f64 oracle)
    np.testing.assert_allclose(np.abs(rf), np.abs(expected), atol=5e-3)


def test_window_shot_matches_oracle(rng):
    kp, vals_ff, dist_inf = window_case(rng, q=10, w=160, radius=RADIUS)
    desc, rfs = _shot(kp, vals_ff, dist_inf)
    assert desc.shape == (10, 352)
    for i in range(10):
        nb, nrm = _members(vals_ff, dist_inf, i)
        _assert_frame(rfs[i], kp[i], nb, RADIUS)
        expected = oracle_shot(kp[i], nb, nrm, RADIUS, rfs[i], 5)
        np.testing.assert_allclose(desc[i], expected, atol=2e-3)
    assert np.abs(desc).sum() > 0


def test_window_shot_empty_neighborhood(rng):
    kp, vals_ff, dist_inf = window_case(rng, q=8, w=96, radius=RADIUS)
    dist_inf[5] = np.inf
    dist_inf[2, 3:] = np.inf            # 3 neighbors: at most min size 5
    desc, rfs = _shot(kp, vals_ff, dist_inf)
    assert np.all(desc[5] == 0) and np.all(desc[2] == 0)
    np.testing.assert_array_equal(rfs[5], np.eye(3))   # identity frame
    assert np.abs(desc[[0, 1, 3, 4, 6, 7]]).sum() > 0


def test_window_shot_query_padding(rng):
    """Sentinel-padded queries (far keypoint, empty window — how the chunked
    grid path pads) give zero rows and leave the real rows unchanged."""
    kp, vals_ff, dist_inf = window_case(rng, q=6, w=128, radius=RADIUS)
    base, _ = _shot(kp, vals_ff, dist_inf)
    pad = 4
    kp_p = np.concatenate([kp, np.full((pad, 3), 1.0e6, np.float32)])
    vals_p = np.concatenate([vals_ff, np.zeros((pad,) + vals_ff.shape[1:],
                                               np.float32)])
    dist_p = np.concatenate([dist_inf, np.full((pad, dist_inf.shape[1]),
                                               np.inf, np.float32)])
    padded, _ = _shot(kp_p, vals_p, dist_p)
    np.testing.assert_allclose(padded[:6], base, atol=1e-6)
    assert np.all(padded[6:] == 0)


def test_window_shot_biscale_rf_plane(rng):
    """Bi-scale: frames from the ``rf_radius`` validity plane of the same
    window, bins from ``radius`` (reference shot_parallelization.py:185-239)."""
    rf_radius = 1.2
    kp, vals_ff, rf_dist_inf = window_case(rng, q=10, w=192, radius=rf_radius)
    dist_inf = np.where(rf_dist_inf <= RADIUS, rf_dist_inf, np.inf).astype(
        np.float32)
    desc, rfs = _shot(kp, vals_ff, dist_inf,
                      rf_dist_inf=jnp.asarray(rf_dist_inf), rf_radius=rf_radius)
    for i in range(10):
        rf_nb, _ = _members(vals_ff, rf_dist_inf, i)
        _assert_frame(rfs[i], kp[i], rf_nb, rf_radius)
        nb, nrm = _members(vals_ff, dist_inf, i)
        expected = oracle_shot(kp[i], nb, nrm, RADIUS, rfs[i], 5)
        np.testing.assert_allclose(desc[i], expected, atol=2e-3)


def _oracle_spfh_window(q, qn, vals_ff, dist_inf, n_bins, decorrelated):
    """Per-query SPFH over a window's members, with the reference's
    ``histogramdd`` range semantics (out-of-range angles dropped; the query
    itself counted in the size but contributing no angles)."""
    out = []
    rng_ = [(-1, 1), (-1, 1), (-np.pi / 2, np.pi / 2)]
    for i in range(len(q)):
        ok = np.isfinite(dist_inf[i])
        size = ok.sum()
        nz = ok & (dist_inf[i] > 0)
        p_j = vals_ff[i, :3, nz].astype(np.float64)
        n_j = vals_ff[i, 3:6, nz].astype(np.float64)
        diff = p_j - q[i]
        u = qn[i].astype(np.float64)
        v = np.cross(diff, np.broadcast_to(u, diff.shape))
        w = np.cross(np.broadcast_to(u, v.shape), v)
        alpha = np.sum(v * n_j, axis=1)
        phi = diff @ u / np.linalg.norm(diff, axis=1)
        theta = np.arctan2(np.sum(n_j * w, axis=1), n_j @ u)
        if decorrelated:
            h = np.stack([np.histogram(a, bins=n_bins, range=r)[0]
                          for a, r in zip((alpha, phi, theta), rng_)], axis=-1)
        else:
            h, _ = np.histogramdd(np.stack([alpha, phi, theta], axis=1),
                                  bins=n_bins, range=rng_)
        out.append(h.ravel() / max(size, 1))
    return np.asarray(out)


@pytest.mark.parametrize("n_bins,decorrelated,dim", [
    (11, True, 33),     # the 33-D decorrelated FPFH of 3DMatch-style pipelines
    (5, False, 125),    # the reference's default joint 5^3 histogram
])
def test_window_spfh_matches_oracle(rng, n_bins, decorrelated, dim):
    q, qn, vals_ff, dist_inf = window_case(rng, q=12, w=160, radius=RADIUS,
                                           query_normals=True)
    dist_inf[4, 7] = 0.0                 # the query itself: size, no angles
    got = np.asarray(spfh_from_window(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(vals_ff),
        jnp.asarray(dist_inf), n_bins, decorrelated))
    assert got.shape == (12, dim)
    expected = _oracle_spfh_window(q, qn, vals_ff, dist_inf, n_bins,
                                   decorrelated)
    # an angle within f32 rounding of a bin edge may land one bin over:
    # allow a single moved count (1/size) in a few rows
    diff = np.abs(got - expected)
    assert (diff > 1e-5).any(axis=1).sum() <= 2, np.nonzero(diff > 1e-5)
    np.testing.assert_allclose(got.sum(axis=1), expected.sum(axis=1),
                               atol=1e-5)


def test_window_spfh_empty_neighborhood(rng):
    q, qn, vals_ff, dist_inf = window_case(rng, q=8, w=96, radius=RADIUS,
                                           query_normals=True)
    dist_inf[2] = np.inf
    got = np.asarray(spfh_from_window(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(vals_ff),
        jnp.asarray(dist_inf), 11, True))
    assert np.all(got[2] == 0)
    assert np.abs(got).sum() > 0
