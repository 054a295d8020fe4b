"""Direct tests of the shared bin-convention module (ops.descriptor_bins).

The consumers (the SHOT and SPFH window paths and their sharded and fused
variants) are oracle-tested elsewhere; here the merged 2-group terms are
pinned against the raw ten reference contributions (shot.py:237-298) as an
algebraic identity, and the arithmetic-only primitives against their NumPy
counterparts.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from shot_fpfh_tpu.ops.descriptor_bins import (
    N_AZ,
    N_COS,
    N_LO,
    azimuth_bin,
    cell_index,
    darboux_angles,
    shot_soft_bins,
    wrap,
)


def _random_local_frame_batch(n, seed):
    rng = np.random.default_rng(seed)
    radius = 0.8
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts *= (rng.uniform(0.02, 1.0, size=(n, 1)) ** (1 / 3)) * radius
    rho = np.linalg.norm(pts, axis=1)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cosine = np.clip(nrm[:, 2], -1.0, 1.0)
    lx, ly, lz = pts.T
    theta = np.arctan2(ly, lx)
    phi = np.arccos(np.clip(lz / np.maximum(rho, 1e-12), -1.0, 1.0))
    return lx, ly, lz, rho, theta, phi, cosine, radius


def _dense_hist_raw(sb, n):
    """352-bin histogram from the TEN raw reference contributions."""
    h = np.zeros((n, N_COS, N_LO), np.float64)
    cos_bin = np.asarray(sb.cos_bin)
    cos_nb = np.asarray(sb.cos_nb)
    az_bin = np.asarray(sb.az_bin)
    az_nb = np.asarray(sb.az_nb)
    elev = np.asarray(sb.elev_bin)
    rad = np.asarray(sb.rad_bin)
    cell = lambda a, e, r: (a * 2 + e) * 2 + r  # noqa: E731
    base = cell(az_bin, elev, rad)
    rows = np.arange(n)
    contributions = [
        (cos_nb, base, np.asarray(sb.abs_cos)),
        (cos_bin, base, 1.0 - np.asarray(sb.abs_cos)),
        (cos_bin, cell(az_bin, elev, np.ones_like(rad)),
         np.asarray(sb.outer) * (rad == 0)),
        (cos_bin, cell(az_bin, elev, np.zeros_like(rad)),
         np.asarray(sb.inner) * (rad == 1)),
        (cos_bin, base, np.asarray(sb.husk_cur)),
        (cos_bin, cell(az_bin, np.ones_like(elev), rad),
         np.asarray(sb.upper) * (elev == 0)),
        (cos_bin, cell(az_bin, np.zeros_like(elev), rad),
         np.asarray(sb.lower) * (elev == 1)),
        (cos_bin, base, np.asarray(sb.vert_cur)),
        (cos_bin, cell(az_nb, elev, rad), np.asarray(sb.abs_az)),
        (cos_bin, base, 1.0 - np.asarray(sb.abs_az)),
    ]
    for hi, lo, w in contributions:
        np.add.at(h, (rows, hi, lo), w)
    return h


def _dense_hist_merged(sb, n):
    """Same histogram from the merged 2-group terms."""
    h = np.zeros((n, N_COS, N_LO), np.float64)
    rows = np.arange(n)
    for hi, lo, w in [
        (sb.cos_bin, sb.base, sb.w_same),
        (sb.cos_bin, sb.lo_husk, sb.w_husk_nb),
        (sb.cos_bin, sb.lo_vert, sb.w_vert_nb),
        (sb.cos_bin, sb.lo_az, sb.abs_az),
        (sb.cos_nb, sb.base, sb.abs_cos),
    ]:
        np.add.at(h, (rows, np.asarray(hi), np.asarray(lo)), np.asarray(w))
    return h


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_terms_equal_raw_contributions(seed):
    n = 4096
    args = _random_local_frame_batch(n, seed)
    sb = shot_soft_bins(*[jnp.asarray(a) for a in args[:7]], args[7])
    np.testing.assert_allclose(
        _dense_hist_merged(sb, n), _dense_hist_raw(sb, n), rtol=0, atol=1e-6
    )


def test_bin_ranges():
    args = _random_local_frame_batch(8192, 2)
    sb = shot_soft_bins(*[jnp.asarray(a) for a in args[:7]], args[7])
    for name, arr, hi in [
        ("cos_bin", sb.cos_bin, N_COS), ("cos_nb", sb.cos_nb, N_COS),
        ("az_bin", sb.az_bin, N_AZ), ("az_nb", sb.az_nb, N_AZ),
        ("elev_bin", sb.elev_bin, 2), ("rad_bin", sb.rad_bin, 2),
        ("base", sb.base, N_LO), ("lo_husk", sb.lo_husk, N_LO),
        ("lo_vert", sb.lo_vert, N_LO), ("lo_az", sb.lo_az, N_LO),
    ]:
        a = np.asarray(arr)
        assert a.min() >= 0 and a.max() < hi, name


def test_wrap_matches_mod_on_domain():
    v = jnp.arange(-1, 12)
    np.testing.assert_array_equal(np.asarray(wrap(v, 11)),
                                  np.asarray(v) % 11)


def test_azimuth_bin_octants():
    # one representative direction per octant plus axis-aligned edge cases
    ang = np.linspace(-np.pi + 1e-3, np.pi - 1e-3, 64)
    x = np.cos(ang).astype(np.float32)
    y = np.sin(ang).astype(np.float32)
    bins = np.asarray(azimuth_bin(jnp.asarray(x), jnp.asarray(y)))
    assert bins.min() >= 0 and bins.max() < N_AZ
    assert len(np.unique(bins)) == N_AZ
    # edges: the reference convention puts +x in a different half than -x
    edge = np.asarray(azimuth_bin(jnp.asarray([1.0, -1.0, 0.0, 0.0]),
                                  jnp.asarray([0.0, 0.0, 1.0, -1.0])))
    assert len(set(edge.tolist())) == 4


def test_cell_index_bijective():
    seen = set()
    for a in range(N_AZ):
        for e in range(2):
            for r in range(2):
                seen.add(int(cell_index(a, e, r)))
    assert seen == set(range(N_LO))


def test_darboux_angles_match_vector_form():
    rng = np.random.default_rng(3)
    n, k = 64, 16
    q = rng.normal(size=(n, 3)).astype(np.float32)
    p = q[:, None, :] + rng.normal(scale=0.3, size=(n, k, 3)).astype(np.float32)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    nj = rng.normal(size=(n, k, 3)).astype(np.float32)
    nj /= np.linalg.norm(nj, axis=-1, keepdims=True)

    diff = p - q[:, None, :]
    d = np.linalg.norm(diff, axis=-1)
    v = np.cross(diff, np.broadcast_to(u[:, None, :], diff.shape))
    w = np.cross(np.broadcast_to(u[:, None, :], diff.shape), v)
    alpha_ref = np.sum(v * nj, axis=-1)
    phi_ref = np.sum(diff * u[:, None, :], axis=-1) / d
    theta_ref = np.arctan2(np.sum(nj * w, axis=-1), np.sum(nj * u[:, None, :], axis=-1))

    alpha, phi, theta = darboux_angles(
        *(jnp.asarray(diff[..., i]) for i in range(3)),
        *(jnp.asarray(nj[..., i]) for i in range(3)),
        *(jnp.asarray(u[:, i:i + 1]) for i in range(3)),
        jnp.asarray(d),
    )
    np.testing.assert_allclose(np.asarray(alpha), alpha_ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(phi), phi_ref, atol=1e-5)
    np.testing.assert_allclose(np.asarray(theta), theta_ref, atol=1e-5)
