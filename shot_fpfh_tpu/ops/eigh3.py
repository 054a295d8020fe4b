"""Batched symmetric 3x3 eigendecomposition via fixed-sweep cyclic Jacobi.

This is the batched "native layer" replacement for the per-neighborhood
``np.linalg.eigh`` calls in the reference (normals:
descriptors/pca_based_descriptors.py:24, SHOT local RFs:
descriptors/shot.py:36).  The reference calls LAPACK once per 3x3 matrix inside
a Python loop; here the entire batch is one vectorized computation — a handful
of fused elementwise 3x3 updates, with no data-dependent control flow, so it
vmaps/shards freely over keypoint blocks.

Cyclic Jacobi on a 3x3 symmetric matrix converges to machine precision in a
handful of sweeps; we run a fixed number (no early exit — cheaper than a
convergence check and fully deterministic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 3x3 cyclic Jacobi converges to the f32 residual floor by sweep 3 (measured
# across random SPD / near-planar / near-linear / near-isotropic batches);
# one extra sweep of margin.
_N_SWEEPS = 4


def _rotate_planes(a, v, p: int, q: int):
    """One Jacobi rotation zeroing A[p, q], on scalar planes.

    ``a`` is the symmetric matrix as a dict of 6 batched scalars
    {(i, j): plane} with i <= j; ``v`` is the eigenvector matrix as
    {(row, col): plane}.  Everything is flat elementwise arithmetic on
    (...,)-shaped arrays — no (.., 3, 3) batched matmuls, which lower to ~36
    tiny dot_generals and dominated the old implementation.
    """
    r = ({0, 1, 2} - {p, q}).pop()
    key = lambda i, j: (i, j) if i <= j else (j, i)  # noqa: E731
    app, aqq, apq = a[key(p, p)], a[key(q, q)], a[key(p, q)]
    apr, aqr = a[key(p, r)], a[key(q, r)]
    theta = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    c2, s2, cs = c * c, s * s, c * s

    out = dict(a)
    out[key(p, p)] = c2 * app - 2.0 * cs * apq + s2 * aqq
    out[key(q, q)] = s2 * app + 2.0 * cs * apq + c2 * aqq
    out[key(p, q)] = cs * (app - aqq) + (c2 - s2) * apq
    out[key(p, r)] = c * apr - s * aqr
    out[key(q, r)] = s * apr + c * aqr

    vout = dict(v)
    for row in range(3):
        vp, vq = v[(row, p)], v[(row, q)]
        vout[(row, p)] = c * vp - s * vq
        vout[(row, q)] = s * vp + c * vq
    return out, vout


def eigh3x3(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Eigendecomposition of symmetric 3x3 matrices ``[..., 3, 3]``.

    Returns ``(w, v)`` with eigenvalues ``w[..., 3]`` ascending and eigenvectors
    as columns ``v[..., :, i]`` — the same convention as ``np.linalg.eigh``.

    Implementation: fixed-sweep cyclic Jacobi unpacked into scalar planes
    (6 matrix entries + 9 eigenvector entries as flat batched arrays), then an
    explicit 3-element sorting network — no argsort/gather on tiny minor dims.
    """
    dtype = a.dtype
    # Scale to unit magnitude for numerical headroom in f32.
    scale = jnp.maximum(jnp.max(jnp.abs(a), axis=(-1, -2), keepdims=True), 1e-30)
    an = a / scale
    planes = {(i, j): an[..., i, j] for i in range(3) for j in range(3) if i <= j}
    # Derive the identity planes from the input so their device-varying
    # annotation matches the loop carry under shard_map.
    zero = planes[(0, 0)] * 0.0
    one = zero + 1.0
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}

    # one sweep per fori_loop iteration keeps the emitted graph small (the
    # fully unrolled 18-rotation graph stalls XLA:CPU's compile passes)
    def sweep(_, carry):
        planes, v = carry
        planes, v = _rotate_planes(planes, v, 0, 1)
        planes, v = _rotate_planes(planes, v, 0, 2)
        planes, v = _rotate_planes(planes, v, 1, 2)
        return planes, v

    planes, v = jax.lax.fori_loop(0, _N_SWEEPS, sweep, (planes, v))

    s0 = jnp.squeeze(scale, (-1, -2))
    w = [planes[(0, 0)] * s0, planes[(1, 1)] * s0, planes[(2, 2)] * s0]
    cols = [[v[(r, c)] for r in range(3)] for c in range(3)]

    # ascending sort network on (w, column) pairs: (0,1), (1,2), (0,1)
    def cswap(i, j):
        swap = w[i] > w[j]
        w[i], w[j] = jnp.where(swap, w[j], w[i]), jnp.where(swap, w[i], w[j])
        ci = [jnp.where(swap, b, a_) for a_, b in zip(cols[i], cols[j])]
        cj = [jnp.where(swap, a_, b) for a_, b in zip(cols[i], cols[j])]
        cols[i], cols[j] = ci, cj

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    w_out = jnp.stack(w, axis=-1)
    v_out = jnp.stack(
        [jnp.stack(col, axis=-1) for col in cols], axis=-1
    )  # [..., row, col]
    return w_out, v_out


@jax.jit
def pca_eigh(points: jnp.ndarray, mask: jnp.ndarray | None = None):
    """PCA of (masked) neighborhoods: ``points[..., K, 3]`` -> (w, v, barycenter).

    Covariance follows the reference's ``pca`` helper
    (descriptors/pca_based_descriptors.py:15-26): mean-centered, divided by the
    neighbor count.  ``mask[..., K]`` selects valid neighbors (fixed-shape
    padding); an empty neighborhood yields zeros / identity.
    """
    if mask is None:
        count = jnp.array(points.shape[-2], dtype=points.dtype)
        bary = jnp.mean(points, axis=-2)
        centered = points - bary[..., None, :]
        cov = jnp.einsum("...ki,...kj->...ij", centered, centered) / count
    else:
        m = mask.astype(points.dtype)
        count = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
        bary = jnp.sum(points * m[..., None], axis=-2) / count[..., None]
        centered = (points - bary[..., None, :]) * m[..., None]
        cov = jnp.einsum("...ki,...kj->...ij", centered, centered) / count[..., None, None]
    w, v = eigh3x3(cov)
    return w, v, bary
