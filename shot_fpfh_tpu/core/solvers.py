"""Closed-form rigid alignment solvers, batched and mask-weighted.

Batched rewrites of the reference solvers (core/solvers.py:9-48):

- ``solve_point_to_point`` — Kabsch/Umeyama via 3x3 SVD with the det<0
  reflection fix.  Accepts an optional per-point weight/mask so ICP's inlier
  selection and RANSAC's fixed-size draws need no dynamic shapes, and batches
  over leading axes so 10k RANSAC draws solve in one fused call.
- ``solve_point_to_plane`` — small-angle linearized least squares on the 6x6
  normal equations ``GᵀG x = Gᵀh`` with ``G = [scan x n | n]``, again
  mask-weighted; the 6x6 solve is tiny and stays on-device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .transform import RigidTransform, euler_xyz_to_matrix


def solve_point_to_point(
    scan: jnp.ndarray, ref: jnp.ndarray, weights: jnp.ndarray | None = None
) -> RigidTransform:
    """Least-squares rigid transform mapping ``scan`` onto ``ref``.

    ``scan``/``ref``: ``[..., N, 3]`` corresponding points.
    ``weights``: optional ``[..., N]`` non-negative weights (e.g. inlier masks).
    """
    dtype = scan.dtype
    if weights is None:
        w = jnp.ones(scan.shape[:-1], dtype)
    else:
        w = weights.astype(dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), jnp.asarray(1e-12, dtype))
    wn = (w / wsum)[..., None]

    scan_bary = jnp.sum(scan * wn, axis=-2)
    ref_bary = jnp.sum(ref * wn, axis=-2)
    cov = jnp.einsum(
        "...ki,...kj->...ij", (scan - scan_bary[..., None, :]) * wn, ref - ref_bary[..., None, :]
    )
    u, _, vt = jnp.linalg.svd(cov)
    v = jnp.swapaxes(vt, -1, -2)
    ut = jnp.swapaxes(u, -1, -2)
    rot = v @ ut
    # Reflection fix: flip the last row of Uᵀ when det < 0.
    det = jnp.linalg.det(rot)
    flip = jnp.where(det < 0, -1.0, 1.0).astype(dtype)[..., None, None]
    ut_fixed = jnp.concatenate([ut[..., :2, :], ut[..., 2:3, :] * flip], axis=-2)
    rot = v @ ut_fixed
    trans = ref_bary - jnp.einsum("...ij,...j->...i", rot, scan_bary)
    return RigidTransform(rot, trans)


def solve_point_to_plane(
    scan: jnp.ndarray,
    ref: jnp.ndarray,
    ref_normals: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> RigidTransform:
    """Linearized point-to-plane alignment (small-angle assumption).

    Solves ``min Σ w ((R s + t - r)·n)²`` with R ≈ I + [α,β,γ]x via the 6x6
    normal equations; the rotation is rebuilt as extrinsic-xyz Euler angles,
    matching the reference (core/solvers.py:46-48).
    """
    dtype = scan.dtype
    if weights is None:
        w = jnp.ones(scan.shape[:-1], dtype)
    else:
        w = weights.astype(dtype)
    g = jnp.concatenate([jnp.cross(scan, ref_normals), ref_normals], axis=-1)  # [..., N, 6]
    h = jnp.sum((ref - scan) * ref_normals, axis=-1)  # [..., N]
    gw = g * w[..., None]
    gtg = jnp.einsum("...ki,...kj->...ij", gw, g)
    gth = jnp.einsum("...ki,...k->...i", gw, h)
    # Tiny Tikhonov term keeps the 6x6 solve stable in f32 on degenerate inlier
    # sets without measurably perturbing well-posed solutions.
    gtg = gtg + jnp.eye(6, dtype=dtype) * 1e-8 * jnp.trace(gtg)[..., None, None]
    x = jnp.linalg.solve(gtg, gth)
    return RigidTransform(euler_xyz_to_matrix(x[..., :3]), x[..., 3:])


def point_to_point_stats(scan, ref, weights):
    """Per-shard sufficient statistics for distributed Kabsch: returns
    ``(W, Σw·s, Σw·r, Σw·s·rᵀ)`` — 22 floats, psum-able across the mesh."""
    w = weights[..., None]
    return (
        jnp.sum(weights, axis=-1),
        jnp.sum(scan * w, axis=-2),
        jnp.sum(ref * w, axis=-2),
        jnp.einsum("...ki,...kj->...ij", scan * w, ref),
    )


def solve_point_to_point_from_stats(wsum, s_sum, r_sum, srt) -> RigidTransform:
    """Kabsch from (psum-reduced) sufficient statistics."""
    wsum = jnp.maximum(wsum, 1e-12)
    s_bar = s_sum / wsum[..., None]
    r_bar = r_sum / wsum[..., None]
    cov = srt / wsum[..., None, None] - s_bar[..., :, None] * r_bar[..., None, :]
    u, _, vt = jnp.linalg.svd(cov)
    v = jnp.swapaxes(vt, -1, -2)
    ut = jnp.swapaxes(u, -1, -2)
    rot = v @ ut
    det = jnp.linalg.det(rot)
    flip = jnp.where(det < 0, -1.0, 1.0).astype(cov.dtype)[..., None, None]
    ut_fixed = jnp.concatenate([ut[..., :2, :], ut[..., 2:3, :] * flip], axis=-2)
    rot = v @ ut_fixed
    trans = r_bar - jnp.einsum("...ij,...j->...i", rot, s_bar)
    return RigidTransform(rot, trans)


def solve_point_to_plane_from_normal_eq(gtg: jnp.ndarray, gth: jnp.ndarray) -> RigidTransform:
    """Build the transform from pre-reduced normal equations.

    The multi-chip ICP path psums per-shard ``GᵀG``/``Gᵀh`` (6x6 + 6) over the
    mesh and then calls this — the only data crossing chips is 42 floats.
    """
    gtg = gtg + jnp.eye(6, dtype=gtg.dtype) * 1e-8 * jnp.trace(gtg)[..., None, None]
    x = jnp.linalg.solve(gtg, gth)
    return RigidTransform(euler_xyz_to_matrix(x[..., :3]), x[..., 3:])


def point_to_plane_normal_eq(scan, ref, ref_normals, weights=None):
    """Per-shard reduction for the distributed solver: returns (GᵀG, Gᵀh)."""
    dtype = scan.dtype
    w = jnp.ones(scan.shape[:-1], dtype) if weights is None else weights.astype(dtype)
    g = jnp.concatenate([jnp.cross(scan, ref_normals), ref_normals], axis=-1)
    h = jnp.sum((ref - scan) * ref_normals, axis=-1)
    gw = g * w[..., None]
    return jnp.einsum("...ki,...kj->...ij", gw, g), jnp.einsum("...ki,...k->...i", gw, h)


@jax.jit
def registration_rms(scan: jnp.ndarray, ref: jnp.ndarray, transform: RigidTransform):
    """RMS of 1-NN distances after applying ``transform`` to ``scan`` — the
    reference's ``compute_point_to_point_error`` (core/solvers.py:51-62)."""
    from ..ops.neighbors import nearest_neighbor

    moved = transform.apply(scan)
    dist, _ = nearest_neighbor(moved, ref)
    return jnp.sqrt(jnp.mean(dist**2)), moved
