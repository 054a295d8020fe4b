"""Content-keyed LRU of host->device uploads.

The functional host entry points (icp_*, grid_subsample, matching, ...) take
NumPy arrays and re-upload them per call; at 1M points that is ~12 MB per
array per call.  Hashing the bytes instead costs ~10 ms, so repeated calls
over the same cloud (scan/ref pairs, bench warm reps, interactive refinement
loops) reuse the buffer already resident on the device.  Whether that beats
a plain upload over PCIe is not measured yet (ROADMAP).

Same design as the grid cache (``ops/grid_hash.py``): keyed on CONTENT
(blake2b of the raw bytes + shape + dtype) and the target device, never on
object identity, so in-place mutation or a fresh equal array both behave
correctly; bounded by a byte budget so retained device memory stays
observable and capped.

Knobs: ``SHOT_FPFH_UPLOAD_CACHE`` (max entries, default 16; 0 disables) and
``SHOT_FPFH_UPLOAD_CACHE_BYTES`` (device-byte budget, default 512 MiB).
Arrays below 1 MB bypass the cache — their upload costs less than the
bookkeeping saves.
"""

from __future__ import annotations

import hashlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

_CACHE: dict = {}  # key -> (jax.Array, nbytes)
_MAX_ENTRIES = int(os.environ.get("SHOT_FPFH_UPLOAD_CACHE", "16"))
_MAX_BYTES = int(float(os.environ.get("SHOT_FPFH_UPLOAD_CACHE_BYTES", str(512 << 20))))
_MIN_BYTES = 1 << 20  # below this the upload is cheaper than the hash + LRU


def upload_cache_stats() -> dict:
    """Observability hook: entry count + total retained device bytes."""
    return {
        "entries": len(_CACHE),
        "bytes": sum(nbytes for _, nbytes in _CACHE.values()),
    }


def clear_upload_cache() -> None:
    _CACHE.clear()


def to_device_cached(arr, dtype=jnp.float32) -> jax.Array:
    """``jnp.asarray(arr, dtype)`` with a content-keyed LRU for large host
    arrays.  Device arrays pass straight through (a cast if needed);
    non-cacheable inputs fall back to a plain upload."""
    if isinstance(arr, jax.Array):
        return arr.astype(dtype) if arr.dtype != jnp.dtype(dtype) else arr
    a = np.ascontiguousarray(arr, np.dtype(dtype))
    if _MAX_ENTRIES <= 0 or a.nbytes < _MIN_BYTES:
        return jnp.asarray(a)
    key = (
        a.shape,
        str(a.dtype),
        str(jax.config.jax_default_device),
        hashlib.blake2b(a.tobytes(), digest_size=16).digest(),
    )
    hit = _CACHE.pop(key, None)
    if hit is not None:
        _CACHE[key] = hit  # re-insert: dict preserves order -> LRU
        return hit[0]
    buf = jnp.asarray(a)
    if a.nbytes <= _MAX_BYTES:  # never cache an over-budget array
        _CACHE[key] = (buf, a.nbytes)
    while _CACHE and (
        len(_CACHE) > _MAX_ENTRIES
        or sum(n for _, n in _CACHE.values()) > _MAX_BYTES
    ):
        old_key = next(iter(_CACHE))
        if old_key == key and len(_CACHE) == 1:
            break  # keep at least the entry just inserted
        _, old_bytes = _CACHE.pop(old_key)
        stats = upload_cache_stats()
        logger.debug(
            "upload cache: evicted %.1f MB entry (now %d entries, %.1f MB retained)",
            old_bytes / 2**20, stats["entries"], stats["bytes"] / 2**20,
        )
    stats = upload_cache_stats()
    logger.debug(
        "upload cache: inserted %.1f MB array (%d entries, %.1f MB retained, "
        "budget %d entries / %.0f MB)",
        a.nbytes / 2**20, stats["entries"], stats["bytes"] / 2**20,
        _MAX_ENTRIES, _MAX_BYTES / 2**20,
    )
    return buf
