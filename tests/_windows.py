"""Shared random window-case generator for the window-descriptor tests.

Builds a feature-first candidate window around random keypoints: (Q, 8, W)
``[x y z nx ny nz 0 0]`` rows plus a distance-or-+inf plane, mirroring what
``ops.grid_hash.window_distances`` hands the descriptor paths.
"""

import numpy as np


def window_case(rng, q=12, w=160, radius=0.8, drop=0.1, query_normals=False):
    kp = rng.normal(size=(q, 3)).astype(np.float32)
    pts = kp[:, None, :] + rng.normal(scale=0.4, size=(q, w, 3)).astype(np.float32)
    nrm = rng.normal(size=(q, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    vals_ff = np.moveaxis(
        np.concatenate([pts, nrm, np.zeros((q, w, 2))], axis=-1), 1, 2
    ).astype(np.float32)  # (Q, 8, W) feature-first
    d = np.linalg.norm(pts - kp[:, None, :], axis=-1)
    keep = d <= radius
    if drop:
        keep &= rng.uniform(size=(q, w)) > drop
    dist_inf = np.where(keep, d, np.inf).astype(np.float32)
    if query_normals:
        qn = rng.normal(size=(q, 3))
        qn = (qn / np.linalg.norm(qn, axis=-1, keepdims=True)).astype(np.float32)
        return kp, qn, vals_ff, dist_inf
    return kp, vals_ff, dist_inf
