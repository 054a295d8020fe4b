"""SE(3) rigid transforms as JAX pytrees, plus quaternion/Euler conversions.

Batched replacement for the reference's ``RigidTransform`` wrapper
(/root/reference/shot_fpfh/core/rigid_transform.py:10-106).  Everything here is
pure-functional and jit/vmap friendly: no scipy, no host round-trips, and the
SE(3) inverse is the mathematically correct ``(Rᵀ, -Rᵀ t)`` (the reference's
``__invert__`` returns ``(Rᵀ, -t)``, a known defect — SURVEY.md §2.4.3).

Quaternion layout is ``[x, y, z, w]`` (scalar last), matching scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


def quaternion_to_matrix(q: Array) -> Array:
    """Convert quaternion(s) ``[..., 4]`` (x, y, z, w) to rotation matrices ``[..., 3, 3]``.

    The quaternion need not be normalized; the result uses the normalized form.
    """
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: Array) -> Array:
    """Convert rotation matrices ``[..., 3, 3]`` to quaternions ``[..., 4]`` (x, y, z, w).

    Branchless Shepperd's method: all four pivot candidates are computed and the
    numerically largest one is selected with ``where`` — safe under vmap/jit.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate formulations, each stable when its pivot is the largest.
    # q = [x, y, z, w] in each case, scaled by the unnormalized pivot term.
    qw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    qx = jnp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    qy = jnp.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    qz = jnp.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(pivots, axis=-1)[..., None]
    q = jnp.where(
        best == 0, qw, jnp.where(best == 1, qx, jnp.where(best == 2, qy, qz))
    )
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def euler_xyz_to_matrix(angles: Array) -> Array:
    """Extrinsic x-y-z Euler angles ``[..., 3]`` to rotation matrices ``[..., 3, 3]``.

    Matches ``scipy Rotation.from_euler("xyz", angles)``: rotations about the
    fixed x, then y, then z axes, i.e. ``R = Rz(c) @ Ry(b) @ Rx(a)``.  Used by
    the point-to-plane solver (reference: core/solvers.py:47).
    """
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    m = jnp.stack(
        [
            cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa,
            sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa,
            -sb, cb * sa, cb * ca,
        ],
        axis=-1,
    )
    return m.reshape(angles.shape[:-1] + (3, 3))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidTransform:
    """An SE(3) transform ``p -> R p + t`` as an immutable JAX pytree.

    Unlike the reference's mutable class, composition and inversion return new
    values, so instances flow freely through ``jit``/``vmap``/``lax.scan``.
    Batched transforms (leading axes on ``rotation``/``translation``) are
    supported by all methods.
    """

    rotation: Array
    translation: Array

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape: tuple = ()) -> "RigidTransform":
        rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
        t = jnp.zeros(batch_shape + (3,), dtype=dtype)
        return RigidTransform(rot, t)

    def apply(self, points: Array) -> Array:
        """Apply to ``[..., N, 3]`` points (reference ``__getitem__``: p·Rᵀ + t)."""
        return points @ jnp.swapaxes(self.rotation, -1, -2) + self.translation[..., None, :]

    def __matmul__(self, other: "RigidTransform") -> "RigidTransform":
        """Composition ``self ∘ other`` (other applied first), with the rotation
        renormalized through quaternion space as the reference does
        (rigid_transform.py:54-70)."""
        rot = self.rotation @ other.rotation
        t = jnp.einsum("...ij,...j->...i", self.rotation, other.translation) + self.translation
        return RigidTransform(rot, t).normalize_rotation()

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        return self @ other

    def inverse(self) -> "RigidTransform":
        """Correct SE(3) inverse ``(Rᵀ, -Rᵀ t)``."""
        rot_t = jnp.swapaxes(self.rotation, -1, -2)
        return RigidTransform(rot_t, -jnp.einsum("...ij,...j->...i", rot_t, self.translation))

    def inv(self) -> "RigidTransform":
        return self.inverse()

    def normalize_rotation(self) -> "RigidTransform":
        """Project the rotation back onto SO(3) via quaternion normalization."""
        q = matrix_to_quaternion(self.rotation)
        return RigidTransform(quaternion_to_matrix(q), self.translation)

    def as_matrix(self) -> Array:
        """Homogeneous ``[..., 4, 4]`` matrix."""
        batch = self.rotation.shape[:-2]
        top = jnp.concatenate([self.rotation, self.translation[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), batch + (1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)

    def __repr__(self) -> str:  # CloudCompare-pasteable, like the reference
        try:
            mat = np.asarray(self.as_matrix())
        except Exception:  # tracers
            return f"RigidTransform(rotation={self.rotation}, translation={self.translation})"
        with np.printoptions(suppress=True):
            return str(mat).replace("[", "").replace("]", "")


def rotation_angle(r1: Array, r2: Array) -> Array:
    """Geodesic angle between two rotations — the registration error metric
    logged by the reference (pipeline.py:478-484)."""
    cos = (jnp.trace(r1 @ jnp.swapaxes(r2, -1, -2)) - 1.0) / 2.0
    return jnp.abs(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))
