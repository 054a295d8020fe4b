import numpy as np
import jax
import jax.numpy as jnp

from shot_fpfh_tpu.core import rotation_angle
from shot_fpfh_tpu.models import compute_normals
from shot_fpfh_tpu.registration.fused import register_pair
from tests.test_pipeline import make_pair
import pytest


@pytest.mark.slow
def test_fused_registration_recovers_ground_truth(rng):
    scan, ref, exact = make_pair(rng, n=2500)
    scan_n = np.asarray(compute_normals(scan, scan, k=20))
    ref_n = np.asarray(compute_normals(ref, ref, k=20))
    res = register_pair(
        scan, scan_n, ref, ref_n,
        keypoint_voxel=0.25, icp_voxel=0.1, radius=0.5,
        ratio_threshold=0.9, ransac_threshold=0.3, d_max=0.3,
        k_max=256, min_neighborhood_size=10, n_draws=1536, max_iter=40,
    )
    ang = float(rotation_angle(res.icp_transform.rotation, exact.rotation))
    terr = float(jnp.linalg.norm(res.icp_transform.translation - exact.translation))
    assert int(res.n_matches) > 20
    assert ang < 0.02, f"fused pipeline rotation error {np.degrees(ang):.2f} deg"
    assert terr < 0.05


def test_fused_is_single_program(rng):
    """The full pipeline must trace into one jitted computation."""
    from shot_fpfh_tpu.registration.fused import fused_registration

    scan, ref, _ = make_pair(rng, n=600)
    scan_n = np.asarray(compute_normals(scan, scan, k=10))
    ref_n = np.asarray(compute_normals(ref, ref, k=10))
    kp = jnp.asarray(scan[:64], jnp.float32)
    rkp = jnp.asarray(ref[:64], jnp.float32)
    valid = jnp.ones(64, bool)
    sub = jnp.asarray(scan[::4], jnp.float32)
    lowered = fused_registration.lower(
        kp, valid, rkp, valid,
        jnp.asarray(scan, jnp.float32), jnp.asarray(scan_n, jnp.float32),
        jnp.asarray(ref, jnp.float32), jnp.asarray(ref_n, jnp.float32),
        sub, jnp.ones(len(sub), bool), jax.random.key(0),
        radius=0.5, k_max=64, min_neighborhood_size=5, n_draws=256, max_iter=5,
    )
    text = lowered.as_text()
    assert "while" in text  # the ICP loop is inside the single program


@pytest.mark.slow
def test_fused_registration_grid_path_matches_brute():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from shot_fpfh_tpu.ops.grid_hash import build_grid
    from shot_fpfh_tpu.registration.fused import fused_registration

    rng = np.random.default_rng(5)
    xy = rng.uniform(-3, 3, size=(600, 2))
    z = 0.5 * np.sin(1.5 * xy[:, 0]) * np.cos(1.1 * xy[:, 1])
    ref = np.column_stack([xy, z]).astype(np.float32)
    nrm = rng.normal(size=(600, 3)); nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm.astype(np.float32)
    scan = ref + np.float32(0.05)
    kp = jnp.asarray(ref[:64])
    valid = jnp.ones(64, bool)
    args = (kp + 0.05, valid, kp, valid, jnp.asarray(scan), jnp.asarray(nrm),
            jnp.asarray(ref), jnp.asarray(nrm),
            jnp.asarray(scan[::4]), jnp.ones(150, bool), jax.random.key(0))
    kw = dict(radius=1.0, k_max=64, min_neighborhood_size=3, n_draws=128,
              max_iter=5)
    res_brute = fused_registration(*args, **kw)
    grids = dict(
        scan_grid=build_grid(scan, 1.0, extras=nrm),
        ref_grid=build_grid(ref, 1.0, extras=nrm),
        ref_icp_grid=build_grid(ref, 0.3),
    )
    res_grid = fused_registration(*args, **kw, **grids)
    # same matches and transforms (search results identical up to tie order)
    assert int(res_brute.n_matches) == int(res_grid.n_matches)
    assert np.allclose(np.asarray(res_brute.icp_transform.rotation),
                       np.asarray(res_grid.icp_transform.rotation), atol=1e-3)
    assert np.allclose(np.asarray(res_brute.icp_transform.translation),
                       np.asarray(res_grid.icp_transform.translation), atol=1e-3)
