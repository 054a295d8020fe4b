"""Shared descriptor bin/angle conventions — the single source of truth.

SHOT's quadrilinear soft-binning (reference
/root/reference/shot_fpfh/descriptors/shot.py:51-306: azimuth octants, radial
husks at r/4 and 3r/4, elevation volumes at pi/4 and 3pi/4, cosine
round-half-even, wrap-around azimuth) and FPFH's Darboux frame (reference
/root/reference/shot_fpfh/descriptors/fpfh.py:50-66) are each consumed by
multiple programs (``models.shot._shot_accumulate``,
``models.fpfh._spfh_window_block`` and the sharded and fused variants), so
the conventions live here exactly once.

Everything in this module is elementwise ``jnp``; callers pass theta/phi
computed with ``jnp.arctan2``/``arccos``.  Parity with the reference is
guarded independently by the NumPy re-derivation oracles in
``tests/test_shot.py`` / ``tests/test_fpfh.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

N_COS = 11   # cosine (normal-angle) bins
N_AZ = 8     # azimuth octants
N_ELEV = 2   # elevation volumes
N_RAD = 2    # radial husks
N_LO = N_AZ * N_ELEV * N_RAD            # 32 spatial cells
SHOT_DIM = N_COS * N_LO                 # 352


def wrap(v, n):
    """``v mod n`` for ``v`` in [-1, n] without an integer rem op;
    identical to ``%`` on that domain."""
    v = jnp.where(v < 0, v + n, v)
    return jnp.where(v >= n, v - n, v)


def azimuth_bin(x, y):
    """8-way azimuth octant of (x, y), clockwise, first bin between pi and
    3pi/4 — bit-for-bit the reference convention (shot.py:51-70).

    Arithmetic-only formulation: booleans cast to int32 immediately and
    ``a + h - 2ah`` is xor."""
    a = ((y > 0) | ((y == 0) & (x < 0))).astype(jnp.int32)
    h = ((x > 0) | ((x == 0) & (y > 0))).astype(jnp.int32)
    cond = ((x * y > 0) | (x == 0)).astype(jnp.int32)
    lt = (jnp.abs(x) < jnp.abs(y)).astype(jnp.int32)
    gt = (jnp.abs(x) > jnp.abs(y)).astype(jnp.int32)
    corner = cond * lt + (1 - cond) * gt
    xor = a + h - 2 * a * h
    return 4 * a + 2 * xor + corner


def interpolate_husks(distance, radius):
    """Radial soft-binning between the two husks centered at r/4 and 3r/4
    (reference shot.py:73-118).  Returns (outer, inner, current) weights —
    "outer" flows from the inner husk (d < r/2) toward the outer bin and
    vice versa."""
    r = radius
    half = r / 2.0
    inner = ((distance > half) & (distance < r * 0.75)) * (r * 0.75 - distance) / half
    outer = ((distance < half) & (distance > r * 0.25)) * (distance - r * 0.25) / half
    current = (distance < half) * (1.0 - jnp.abs(distance - r * 0.25) / half) + (
        distance > half
    ) * (1.0 - jnp.abs(distance - r * 0.75) / half)
    return outer, inner, current


def interpolate_vertical(phi, z):
    """Elevation soft-binning between volumes centered at pi/4 and 3pi/4
    (reference shot.py:121-171).  Returns (upper, lower, current) weights."""
    half_pi = jnp.pi / 2.0
    at_edge = jnp.abs(phi - half_pi) < 1e-10
    upper = (
        (((phi > half_pi) | (at_edge & (z <= 0))) & (phi <= jnp.pi * 0.75))
        * (jnp.pi * 0.75 - phi)
        / half_pi
    )
    lower = (
        (((phi < half_pi) & (~at_edge | (z > 0))) & (phi >= jnp.pi * 0.25))
        * (phi - jnp.pi * 0.25)
        / half_pi
    )
    current = (phi < half_pi) * (1.0 - jnp.abs(phi - jnp.pi * 0.25) / half_pi) + (
        phi >= half_pi
    ) * (1.0 - jnp.abs(phi - jnp.pi * 0.75) / half_pi)
    return upper, lower, current


def cell_index(az, elev, rad):
    """Flat index of an (azimuth, elevation, radial) spatial cell in the
    32-cell factor of the 352-bin space."""
    return (az * N_ELEV + elev) * N_RAD + rad


class ShotBins(NamedTuple):
    """All per-neighbor soft-bin indices and weights of one SHOT
    accumulation, both raw (the ten reference contributions) and merged (the
    2-group algebra of ``models.shot._shot_accumulate``: the four
    same-(cos, cell) contributions collapse into ``w_same``; the
    complementary husk/volume pairs into one condition-selected term each)."""

    # bin indices
    cos_bin: jnp.ndarray
    cos_nb: jnp.ndarray
    az_bin: jnp.ndarray
    az_nb: jnp.ndarray
    elev_bin: jnp.ndarray
    rad_bin: jnp.ndarray
    # raw interpolation weights
    abs_cos: jnp.ndarray
    abs_az: jnp.ndarray
    outer: jnp.ndarray
    inner: jnp.ndarray
    husk_cur: jnp.ndarray
    upper: jnp.ndarray
    lower: jnp.ndarray
    vert_cur: jnp.ndarray
    # merged spatial-cell indices + weights
    base: jnp.ndarray
    lo_husk: jnp.ndarray
    lo_vert: jnp.ndarray
    lo_az: jnp.ndarray
    w_same: jnp.ndarray
    w_husk_nb: jnp.ndarray
    w_vert_nb: jnp.ndarray


def shot_soft_bins(lx, ly, lz, rho, theta, phi, cosine, radius) -> ShotBins:
    """Quadrilinear soft-binning of one neighbor batch in local-RF
    coordinates.  ``theta``/``phi`` are the azimuth/elevation angles (callers
    choose the atan2/arccos implementation); validity masking stays with the
    caller (weights here are unmasked)."""
    cos_pos = (cosine + 1.0) * (N_COS / 2.0) - 0.5
    cos_bin = jnp.round(cos_pos).astype(jnp.int32)  # round-half-even, [0, 10]
    az_bin = azimuth_bin(lx, ly)
    elev_bin = (lz > 0).astype(jnp.int32)
    rad_bin = (rho > radius / 2.0).astype(jnp.int32)

    # cosine interpolation
    delta_cos = cos_pos - cos_bin.astype(jnp.float32)
    sign_cos = jnp.sign(delta_cos).astype(jnp.int32)
    abs_cos = jnp.abs(delta_cos)
    cos_nb = wrap(cos_bin + sign_cos, N_COS)

    outer, inner, husk_cur = interpolate_husks(rho, radius)
    upper, lower, vert_cur = interpolate_vertical(phi, lz)

    # azimuth wrap-around
    az_size = 2.0 * jnp.pi / N_AZ
    delta_az = jnp.clip(
        (theta - (-jnp.pi + az_bin.astype(jnp.float32) * az_size)) / az_size
        - 0.5, -0.5, 0.5,
    )
    sign_az = jnp.sign(delta_az).astype(jnp.int32)
    abs_az = jnp.abs(delta_az)
    az_nb = wrap(az_bin + sign_az, N_AZ)

    base = cell_index(az_bin, elev_bin, rad_bin)
    return ShotBins(
        cos_bin=cos_bin, cos_nb=cos_nb, az_bin=az_bin, az_nb=az_nb,
        elev_bin=elev_bin, rad_bin=rad_bin,
        abs_cos=abs_cos, abs_az=abs_az,
        outer=outer, inner=inner, husk_cur=husk_cur,
        upper=upper, lower=lower, vert_cur=vert_cur,
        base=base,
        lo_husk=cell_index(az_bin, elev_bin, 1 - rad_bin),
        lo_vert=cell_index(az_bin, 1 - elev_bin, rad_bin),
        lo_az=cell_index(az_nb, elev_bin, rad_bin),
        w_same=(1.0 - abs_cos) + husk_cur + vert_cur + (1.0 - abs_az),
        w_husk_nb=outer * (rad_bin == 0) + inner * (rad_bin == 1),
        w_vert_nb=upper * (elev_bin == 0) + lower * (elev_bin == 1),
    )


def darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz, d_safe):
    """(alpha, phi, theta) of the reference Darboux frame (fpfh.py:50-66):
    u = query normal, v = diff x u (UNNORMALIZED, the reference's semantics),
    w = u x v; alpha = v.n_j, phi = diff.u / |diff|, theta = atan2(n_j.w,
    n_j.u).  ``d_safe`` is |diff| with invalid/zero lanes replaced by 1."""
    vx = dy * uz - dz * uy
    vy = dz * ux - dx * uz
    vz = dx * uy - dy * ux
    wx = uy * vz - uz * vy
    wy = uz * vx - ux * vz
    wz = ux * vy - uy * vx
    alpha = vx * nx + vy * ny + vz * nz
    phi = (dx * ux + dy * uy + dz * uz) / d_safe
    theta = jnp.arctan2(nx * wx + ny * wy + nz * wz, nx * ux + ny * uy + nz * uz)
    return alpha, phi, theta
