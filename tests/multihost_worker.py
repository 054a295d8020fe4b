"""Worker process for the 2-process multi-host test (spawned via subprocess).

Each worker owns 4 virtual CPU devices; jax.distributed assembles them into
one 8-device global mesh across the two processes — the CPU-backend stand-in
for a 2-host device mesh (SURVEY.md §5 distributed row, BASELINE config #5).
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    coord, nproc, pid, scan_path, ref_path, out_path = sys.argv[1:7]
    from shot_fpfh_tpu.parallel.multihost import run_multihost

    res = run_multihost(
        scan_path, ref_path,
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
        n_draws=800,
        max_iter=30,
    )
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
