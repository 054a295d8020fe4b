"""Performance monitoring utilities (reference helpers/perf_monitoring.py),
made JAX-aware: timers block on async dispatch so wall-clock numbers measure
device work, and stage metrics can be emitted as structured records.
"""

from __future__ import annotations

import json
import logging
from functools import wraps
from time import perf_counter
from typing import Any, Callable

import jax

logger = logging.getLogger(__name__)


def block(x):
    """Block until all arrays in a pytree are ready (for honest timing).
    Device-execution errors propagate here, with the right stage
    attribution."""
    return jax.block_until_ready(x)


def timeit(func: Callable) -> Callable:
    """Log wall-clock of a function, blocking on JAX async results."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = perf_counter()
        result = block(func(*args, **kwargs))
        logger.info("Function %s took %.2f seconds", func.__name__, perf_counter() - start)
        return result

    return wrapper


def runtime_alert(time_limit: float) -> Callable[[Callable], Callable]:
    """Warn when a function exceeds ``time_limit`` seconds."""

    def deco(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(*args, **kwargs):
            start = perf_counter()
            result = block(func(*args, **kwargs))
            elapsed = perf_counter() - start
            if elapsed > time_limit:
                logger.warning(
                    "Function %s took more than %.2f seconds (%.2f seconds)",
                    func.__name__, time_limit, elapsed,
                )
            return result

        return wrapper

    return deco


def checkpoint(time_ref: float | None = None) -> Callable[..., None]:
    """Closure logging elapsed time since the previous call
    (reference helpers/perf_monitoring.py:64-90)."""
    ref = perf_counter() if time_ref is None else time_ref

    def _closure(message: str = "") -> None:
        nonlocal ref
        now = perf_counter()
        if message:
            logger.info("%s: %.2f seconds", message, now - ref)
        ref = now

    return _closure


class Checkpoint:
    """Class-based variant of ``checkpoint``."""

    def __init__(self, time_reference: float | None = None) -> None:
        self._ref = perf_counter() if time_reference is None else time_reference

    def __call__(self, message: str = "") -> None:
        now = perf_counter()
        if message:
            logger.info("%s: %s", message, now - self._ref)
        self._ref = now


class trace_annotation:
    """Context manager adding a ``jax.profiler`` trace annotation around a
    pipeline stage (visible in TensorBoard/xprof traces); no-op if the
    profiler is unavailable."""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None

    def __enter__(self):
        try:
            self._ctx = jax.profiler.TraceAnnotation(self.name)
            self._ctx.__enter__()
        except Exception:
            self._ctx = None
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


def start_profiler_trace(log_dir: str) -> None:
    jax.profiler.start_trace(log_dir)


def stop_profiler_trace() -> None:
    jax.profiler.stop_trace()


class StageMetrics:
    """Structured per-stage metrics: wall-clock + throughput counters,
    dumpable as JSON — the observability upgrade over log-only timers."""

    def __init__(self) -> None:
        self.stages: list[dict[str, Any]] = []
        self._start: float | None = None
        self._name: str | None = None

    def start(self, name: str) -> None:
        self._name = name
        self._annotation = trace_annotation(name)
        self._annotation.__enter__()
        self._start = perf_counter()

    def stop(self, **counters: float) -> dict[str, Any]:
        elapsed = perf_counter() - self._start
        if getattr(self, "_annotation", None) is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        record: dict[str, Any] = {"stage": self._name, "seconds": elapsed}
        for key, value in counters.items():
            record[key] = value
            if value:
                record[f"{key}_per_sec"] = value / elapsed if elapsed > 0 else float("inf")
        self.stages.append(record)
        logger.info("%s", json.dumps(record))
        return record

    def summary(self) -> dict[str, Any]:
        return {
            "total_seconds": sum(s["seconds"] for s in self.stages),
            "stages": self.stages,
        }


def compilation_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself), else ``<checkout>/.jax_cache``.
    The path is part of the cache key, so it stays fixed."""
    import os
    from pathlib import Path

    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(Path(__file__).resolve().parents[2] / ".jax_cache"))


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache so repeat runs skip XLA
    compiles.  Shape bucketing elsewhere (pow-2 cell tables, quantized auto
    radii, padded keypoint sets) keeps the number of distinct entries small
    across cloud pairs.  Sets a directory only when the environment names
    none; returns the directory in use."""
    import os

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
