"""Descriptor-matching kernel vs the XLA tile scan, on the GPU.

Compiles the Pallas Triton top-2 kernel (``ops.match_triton``) for a small
sweep of tile/launch settings (rebinding the module's constants), checks
each against the bf16 ``_top_scan`` and times the kernel at the module's own
settings against ``_top_scan`` at keypoint scale (5k x 5k x 352) and at
scale (100k x 100k x 352), both with bf16 operands.

    python benchmarks/match_kernel.py [--out match_kernel.json]

Refuses to run without a GPU: times from the CPU say nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SWEEP = (  # (bq, bk, dk, num_warps, num_stages)
    (64, 64, 32, 4, 3),
    (128, 64, 32, 4, 3),
    (128, 64, 32, 8, 3),
    (128, 128, 32, 8, 3),
    (128, 128, 64, 8, 2),
    (64, 128, 64, 4, 3),
    (128, 64, 64, 4, 2),
)


def _time(fn, reps: int) -> dict:
    """Median, min and max seconds of ``reps`` warm calls."""
    import jax

    jax.block_until_ready(fn())                     # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="match_kernel.json")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import shot_fpfh_tpu  # noqa: F401  (sets the process matmul precision)
    from shot_fpfh_tpu.ops import match_triton as mt
    from shot_fpfh_tpu.registration.matching import _top_scan

    shipped = (mt.BQ, mt.BK, mt.DK, mt.NUM_WARPS, mt.NUM_STAGES)

    def set_tiles(cfg):
        mt.BQ, mt.BK, mt.DK, mt.NUM_WARPS, mt.NUM_STAGES = cfg
        mt.top2_triton.clear_cache()            # retrace with the new tiles

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(0)
    out = {"card": card, "device_kind": dev.device_kind,
           "shipped_cfg": shipped, "sweep": []}

    def pair(n, d):
        a = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
        b = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
        return a, b, jnp.ones(n, bool)

    a, b, v = pair(100_000, 352)
    ref = [np.asarray(x) for x in _top_scan(a, b, v, True, True)]
    best = None
    for cfg in SWEEP:
        set_tiles(cfg)
        fn = lambda: mt.top2_triton(a, b, v)  # noqa: E731
        try:
            got = [np.asarray(x) for x in fn()]
        except Exception as exc:  # a config the compiler refuses is a result
            rec = {"cfg": cfg, "error": repr(exc)[:300]}
            print(json.dumps(rec), flush=True)
            out["sweep"].append(rec)
            continue
        agree = float((got[0] == ref[0]).mean())
        rel = float(np.max(np.abs(got[1] - ref[1]) / np.maximum(ref[1], 1e-6)))
        sec = _time(fn, args.reps)
        rec = {"cfg": cfg, "seconds": sec, "idx_agree": agree, "d1_rel": rel}
        print(json.dumps(rec), flush=True)
        out["sweep"].append(rec)
        if best is None or sec["median"] < best[1]:
            best = (cfg, sec["median"])
    out["best_cfg"] = best[0]

    set_tiles(shipped)
    timings = {}
    for n in (100_000, 5_000):
        a, b, v = pair(n, 352)
        tag = f"{n}x{n}x352_bf16"
        timings[f"top_scan_{tag}"] = _time(
            lambda: _top_scan(a, b, v, True, True), args.reps)
        timings[f"triton_{tag}"] = _time(lambda: mt.top2_triton(a, b, v),
                                         args.reps)
        print(tag, timings[f"top_scan_{tag}"], timings[f"triton_{tag}"],
              flush=True)
    out["timings"] = timings
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
