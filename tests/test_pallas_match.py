"""Fused matmul + top-2 matching kernel (ops/match_triton.py) — interpret-mode
parity with the XLA tile-scan matcher on CPU; ``chip_smoke.py`` runs the
compiled Triton kernel against the same reference on the GPU.  The kernel
takes bf16 operands, so exact comparisons are made against the bf16 tile scan
or against an oracle of the bf16-rounded operands."""

import numpy as np
import jax.numpy as jnp
import pytest

from shot_fpfh_tpu.ops.match_triton import top2_triton
from shot_fpfh_tpu.registration.matching import _top_scan


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _oracle(a, b):
    d = np.linalg.norm(a[:, None].astype(np.float64) - b[None], axis=-1) ** 2
    i1 = d.argmin(axis=1)
    d1 = d[np.arange(len(a)), i1]
    dm = d.copy()
    dm[np.arange(len(a)), i1] = np.inf
    return i1, d1, dm.min(axis=1)


@pytest.mark.parametrize("n_ref", [100, 1024, 1024 + 77, 2048 + 5])
def test_pallas_top2_matches_oracle_f32(rng, n_ref):
    """The kernel's f32 accumulation of bf16 products against an f64 oracle
    of the same bf16-rounded operands (bf16 x bf16 products are exact in
    f32)."""
    a = rng.normal(size=(150, 24)).astype(np.float32)
    b = rng.normal(size=(n_ref, 24)).astype(np.float32)
    i1_o, d1_o, d2_o = _oracle(_bf16(a), _bf16(b))
    i1, d1, d2 = top2_triton(
        jnp.asarray(a), jnp.asarray(b), jnp.ones(n_ref, bool), interpret=True)
    np.testing.assert_array_equal(np.asarray(i1), i1_o)
    np.testing.assert_allclose(np.asarray(d1), d1_o, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d2), d2_o, atol=1e-4)


def test_pallas_top2_matches_xla_scan_bf16(rng):
    """bf16 kernel vs the bf16 XLA tile scan: identical quantization of the
    operands and the same merge semantics — indices must agree everywhere
    except genuine f32-accumulation-order near-ties."""
    a = rng.normal(size=(300, 32)).astype(np.float32)
    b = rng.normal(size=(1500, 32)).astype(np.float32)
    valid = np.ones(1500, bool)
    valid[7] = valid[1203] = False
    i_x, d1_x, d2_x = _top_scan(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(valid), True, True)
    i_p, d1_p, d2_p = top2_triton(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), interpret=True)
    assert (np.asarray(i_p) == np.asarray(i_x)).mean() > 0.995
    np.testing.assert_allclose(np.asarray(d1_p), np.asarray(d1_x), atol=1e-3)
    np.testing.assert_allclose(np.asarray(d2_p), np.asarray(d2_x), atol=1e-3)
    assert 7 not in np.asarray(i_p) and 1203 not in np.asarray(i_p)


def test_pallas_top2_tie_semantics(rng):
    """Duplicate rows across tile boundaries resolve argmin-first, and the
    duplicate's distance lands in d2 (Lowe rejection)."""
    n_ref = 1024 + 64
    b = rng.normal(size=(n_ref, 8)).astype(np.float32)
    b[1030] = b[5]
    a = b[5:6].copy()
    i1, d1, d2 = top2_triton(
        jnp.asarray(a), jnp.asarray(b), jnp.ones(n_ref, bool), interpret=True)
    assert int(i1[0]) == 5
    assert float(d1[0]) == 0.0 and float(d2[0]) == 0.0


@pytest.mark.parametrize("dim", [33, 352, 704])
def test_triton_top2_descriptor_widths(rng, dim):
    """The descriptor widths the pipeline matches (FPFH 33, SHOT 352,
    bi-scale/multiscale 704) zero-pad to the K-chunk; scan and ref row counts
    that are not tile multiples pad too.  Non-negative unit-norm rows, as the
    SHOT descriptors are.  Both matchers round the operands to bf16 alike;
    the absolute floor (~8 ulp of ‖a‖² + ‖b‖² = 2) covers the f32
    cancellation of the norm expansion, which both share, for the
    near-duplicate pairs."""
    def unit(x):
        x = np.abs(x)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    a = unit(rng.normal(size=(70, dim)))
    b = unit(rng.normal(size=(200, dim)))
    b[:20] = unit(a[:20] + 1e-3 * rng.normal(size=(20, dim)))
    valid = np.ones(200, bool)
    valid[3] = False
    i_x, d1_x, d2_x = _top_scan(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(valid), True, True)
    i_p, d1_p, d2_p = top2_triton(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_x))
    np.testing.assert_allclose(np.asarray(d1_p), np.asarray(d1_x), rtol=1e-4,
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(d2_p), np.asarray(d2_x), rtol=1e-4,
                               atol=2e-6)
    assert np.asarray(i_p)[3] != 3


def test_triton_top2_no_valid_ref(rng):
    """Rows with no valid ref report (0, inf, inf), like the tile scan."""
    a = rng.normal(size=(10, 33)).astype(np.float32)
    b = rng.normal(size=(40, 33)).astype(np.float32)
    i1, d1, d2 = top2_triton(jnp.asarray(a), jnp.asarray(b),
                             jnp.zeros(40, bool), interpret=True)
    assert (np.asarray(i1) == 0).all()
    assert np.isinf(np.asarray(d1)).all() and np.isinf(np.asarray(d2)).all()


def test_matching_routes_kernel_only_for_gpu_bf16():
    """The kernel serves matching on a GPU; every other backend keeps the XLA
    tile scan."""
    from shot_fpfh_tpu.registration.matching import _use_kernel

    assert not _use_kernel()          # tests run on the CPU backend


def test_matching_routes_to_kernel_when_backend_is_gpu(rng, monkeypatch):
    """With the backend reported as a GPU, ``top2_descriptor`` and
    ``nearest_descriptor`` take the kernel (here through the interpreter)
    and agree with the bf16 tile scan."""
    import jax

    from shot_fpfh_tpu.ops import match_triton
    from shot_fpfh_tpu.registration import matching

    calls = []

    def kernel(a, b, b_valid):
        calls.append(a.shape)
        return top2_triton(a, b, b_valid, interpret=True)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(match_triton, "top2_triton", kernel)
    a = jnp.asarray(rng.normal(size=(40, 33)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(90, 33)).astype(np.float32))
    v = jnp.ones(90, bool)
    i_k, d1_k, d2_k = matching.top2_descriptor(a, b, v)
    i_n, d_n = matching.nearest_descriptor(a, b, v)
    assert calls == [(40, 33), (40, 33)]
    i_x, d1_x, d2_x = _top_scan(a, b, v, True, True)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_x))
    np.testing.assert_array_equal(np.asarray(i_n), np.asarray(i_x))
    np.testing.assert_allclose(np.asarray(d1_k), np.sqrt(np.asarray(d1_x)),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(d2_k), np.sqrt(np.asarray(d2_x)),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(d_n), np.asarray(d1_k))
