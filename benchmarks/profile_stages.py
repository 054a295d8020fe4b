"""Per-stage device timing of the bench workload — finds the hot stage.

Each stage is timed with an on-device fori_loop (no per-rep dispatch) and
reported as ms/rep.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bench import make_terrain
    from shot_fpfh_tpu.models.shot import local_reference_frames, shot_from_neighborhoods
    from shot_fpfh_tpu.ops.grid_hash import build_grid, grid_radius_search
    from shot_fpfh_tpu.registration.matching import nearest_descriptor

    n_support = int(os.environ.get("BENCH_N_SUPPORT", 50_000))
    n_keypoints = int(os.environ.get("BENCH_N_KEYPOINTS", 4096))
    radius = float(os.environ.get("BENCH_RADIUS", 0.9))
    k_max = int(os.environ.get("BENCH_K_MAX", 256))
    reps = int(os.environ.get("BENCH_REPS", 5))

    rng = np.random.default_rng(0)
    cloud = make_terrain(n_support, rng)
    normals = rng.normal(size=(n_support, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    keypoints = cloud[rng.choice(n_support, n_keypoints, replace=False)]

    kp = jnp.asarray(keypoints)
    sup = jnp.asarray(cloud)
    nrm = jnp.asarray(normals.astype(np.float32))
    t0 = time.perf_counter()
    grid = build_grid(cloud, radius)
    jax.block_until_ready(grid.points_sorted)
    print(f"grid build (host, once): {time.perf_counter()-t0:.2f}s cap={grid.cell_cap}")

    nbr = grid_radius_search(grid, kp, radius, k_max)
    nb_pts = sup[nbr.idx]
    nb_nrm = nrm[nbr.idx]
    rfs = local_reference_frames(kp, nb_pts, nbr.mask, radius)
    desc = shot_from_neighborhoods(kp, nb_pts, nb_nrm, nbr.mask, rfs, radius,
                                   normalize=True, min_neighborhood_size=100)
    jax.block_until_ready(desc)

    def timed(name, fn, *args):
        @jax.jit
        def loop(*a):
            def body(i, acc):
                # real data dependency on i so XLA cannot hoist the body
                bump = (i.astype(jnp.float32) * 1e-7)
                perturbed = []
                done = False
                for x in a:
                    if not done and jnp.issubdtype(x.dtype, jnp.floating):
                        perturbed.append(x + bump.astype(x.dtype))
                        done = True
                    else:
                        perturbed.append(x)
                if not done and perturbed:
                    # int-only inputs: roll by i (same cost, loop-dependent)
                    perturbed[0] = jnp.roll(perturbed[0], i, axis=0)
                out = fn(*perturbed)
                leaves = jax.tree_util.tree_leaves(out)
                return acc + sum(jnp.sum(l).astype(jnp.float32) for l in leaves)
            return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

        float(loop(*args))  # compile+warm
        t0 = time.perf_counter()
        float(loop(*args))
        ms = (time.perf_counter() - t0) / reps * 1000
        print(f"{name:30s} {ms:8.1f} ms/rep")
        return ms

    timed("grid_radius_search", lambda q: grid_radius_search(grid, q, radius, k_max).dist, kp)
    timed("gather nbr pts+nrm", lambda i: (sup[i], nrm[i]), nbr.idx)
    timed("local_reference_frames", lambda p: local_reference_frames(kp, p, nbr.mask, radius), nb_pts)
    timed("shot_from_neighborhoods",
          lambda p, n, r: shot_from_neighborhoods(kp, p, n, nbr.mask, r, radius,
                                                  normalize=True, min_neighborhood_size=100),
          nb_pts, nb_nrm, rfs)
    timed("nearest_descriptor",
          lambda d: nearest_descriptor(d, d, jnp.ones(d.shape[0], bool))[1], desc)


if __name__ == "__main__":
    main()
