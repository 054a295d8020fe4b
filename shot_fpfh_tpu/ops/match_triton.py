"""Fused distance-matmul + top-2 descriptor matching as a Pallas Triton kernel.

The XLA matcher (``registration.matching._top_scan``) writes every
``(CHUNK, REF_TILE)`` f32 distance tile out of the matmul and reads it back
for the top-2 epilogue.  Here each program owns ``BQ`` scan rows, loops over
the ref set in ``BK``-row tiles, forms each tile's distances from a
tensor-core dot (bf16 operands, f32 accumulation) and reduces them into a
running ``(i1, d1², d2²)`` kept in registers.  Only the descriptors
themselves cross device memory.

Conventions match ``_top_scan(use_bf16=True, want_top2=True)`` exactly:

- squared distances ``max(‖a‖² + ‖b‖² − 2a·b, 0)`` with the norms taken in
  f32 from the compute-dtype values, so self-distances cancel;
- invalid ref rows carry ``‖b‖² = +inf`` and never win; rows with no valid
  ref report ``(0, inf, inf)``;
- ties keep the earliest index: ``argmin`` takes the first minimum within a
  tile and the strict-``<`` merge keeps the earlier tile.

The descriptor width (33 FPFH, 352 SHOT, 704 bi-/multi-scale) is zero-padded
to a multiple of the dot's K-chunk ``DK``; zero columns change no product.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile sizes and launch parameters, set by the sweep in
# ``benchmarks/match_kernel.py`` on an H100 (PERF.md); the sweep rebinds them.
BQ = 64      # scan rows per program
BK = 128     # ref rows per inner tile
DK = 64      # K-chunk of each dot (descriptor width pads to a multiple)
NUM_WARPS = 4
NUM_STAGES = 3


def _kernel(a_ref, an_ref, b_ref, bn_ref, i1_ref, d1_ref, d2_ref, *,
            bk, dk, n_tiles, n_chunks):
    bq = a_ref.shape[0]
    an = an_ref[...]

    def tile(j, carry):
        ci, cd1, cd2 = carry
        rows = pl.ds(pl.multiple_of(j * bk, bk), bk)

        def chunk(k, acc):
            cols = pl.ds(pl.multiple_of(k * dk, dk), dk)
            return acc + pl.dot(a_ref[:, cols], b_ref[rows, cols],
                                trans_b=True,
                                precision=jax.lax.Precision.DEFAULT)

        prod = jax.lax.fori_loop(0, n_chunks, chunk,
                                 jnp.zeros((bq, bk), jnp.float32))
        d2t = jnp.maximum(an[:, None] + bn_ref[rows][None, :] - 2.0 * prod,
                          0.0)
        ti = jnp.argmin(d2t, axis=1).astype(jnp.int32)
        td1 = jnp.min(d2t, axis=1)
        col = jax.lax.broadcasted_iota(jnp.int32, (bq, bk), 1)
        td2 = jnp.min(jnp.where(col == ti[:, None], jnp.inf, d2t), axis=1)
        better = td1 < cd1                        # strict: earlier tile wins
        return (jnp.where(better, j * bk + ti, ci),
                jnp.where(better, td1, cd1),
                jnp.minimum(jnp.maximum(cd1, td1), jnp.minimum(cd2, td2)))

    init = (jnp.zeros((bq,), jnp.int32), jnp.full((bq,), jnp.inf),
            jnp.full((bq,), jnp.inf))
    i1, d1, d2 = jax.lax.fori_loop(0, n_tiles, tile, init)
    i1_ref[...] = i1
    d1_ref[...] = d1
    d2_ref[...] = d2


@functools.partial(jax.jit, static_argnames=("interpret",))
def top2_triton(a: jnp.ndarray, b: jnp.ndarray, b_valid: jnp.ndarray, *,
                interpret: bool = False):
    """Per-row nearest + second-nearest of ``a`` rows among ``b`` rows, from
    bf16 operands with f32 accumulation.

    Returns ``(i1 (n,), d1_sq (n,), d2_sq (n,))``, squared distances, inf
    where no valid ref exists: the contract of
    ``registration.matching._top_scan(use_bf16=True, want_top2=True)``.
    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests)."""
    n, dim = a.shape
    nb = b.shape[0]
    ac = a.astype(jnp.bfloat16)
    bc = b.astype(jnp.bfloat16)
    an = jnp.sum(ac.astype(jnp.float32) ** 2, axis=-1)
    bn = jnp.sum(bc.astype(jnp.float32) ** 2, axis=-1)
    bn = jnp.where(b_valid, bn, jnp.inf)

    bq, bk, dk = BQ, BK, DK
    qp = -(-n // bq) * bq
    kp = -(-nb // bk) * bk
    dp = -(-dim // dk) * dk
    ap = jnp.pad(ac, ((0, qp - n), (0, dp - dim)))
    bp = jnp.pad(bc, ((0, kp - nb), (0, dp - dim)))
    anp = jnp.pad(an, (0, qp - n))
    bnp = jnp.pad(bn, (0, kp - nb), constant_values=jnp.inf)

    kernel = functools.partial(_kernel, bk=bk, dk=dk, n_tiles=kp // bk,
                               n_chunks=dp // dk)
    row = pl.BlockSpec((bq,), lambda i: (i,))
    i1, d1, d2 = pl.pallas_call(
        kernel,
        grid=(qp // bq,),
        in_specs=[
            pl.BlockSpec((bq, dp), lambda i: (i, 0)),
            row,
            pl.BlockSpec((kp, dp), lambda i: (0, 0)),
            pl.BlockSpec((kp,), lambda i: (0,)),
        ],
        out_specs=(row, row, row),
        out_shape=(
            jax.ShapeDtypeStruct((qp,), jnp.int32),
            jax.ShapeDtypeStruct((qp,), jnp.float32),
            jax.ShapeDtypeStruct((qp,), jnp.float32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * qp * kp * dp,
            bytes_accessed=(qp * dp + (qp // bq) * kp * dp) * ac.dtype.itemsize,
            transcendentals=0,
        ),
        interpret=interpret,
        name="top2_match",
    )(ap, anp, bp, bnp)
    return i1[:n], d1[:n], d2[:n]
