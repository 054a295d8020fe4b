"""shot_fpfh_tpu — point-cloud registration in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
``shot-fpfh`` pipeline (normals → keypoints → SHOT/FPFH descriptors → matching
→ RANSAC → ICP), built from fixed-shape masked tensors, batched programs and
``shard_map`` sharding over device meshes; it runs on NVIDIA GPUs and on the
CPU backend.
"""

import jax as _jax

# Geometry kernels (3x3 eigh, Kabsch SVD, squared-distance expansion) are
# precision-critical: a GPU's default f32 matmul runs in TF32 (~3 decimal
# digits), which is not enough for near-degenerate covariances or distance
# cancellation, so every f32 dot asks for full FP32.  Hot large matmuls that
# tolerate lower precision (descriptor matching) opt into bf16 locally.
_jax.config.update("jax_default_matmul_precision", "highest")

from .core import (  # noqa: E402
    RigidTransform,
    grid_subsample,
    registration_rms,
    rotation_angle,
    solve_point_to_plane,
    solve_point_to_point,
)
from .ops import knn, nearest_neighbor, radius_count, radius_search  # noqa: E402


# Reference-parity top-level API (shot_fpfh/__init__.py:1-25), loaded lazily
# to keep `import shot_fpfh_tpu` light.
_LAZY = {
    "RegistrationPipeline": ("shot_fpfh_tpu.pipeline", "RegistrationPipeline"),
    "load_config_from_yaml": ("shot_fpfh_tpu.configuration", "load_config_from_yaml"),
    "compute_normals": ("shot_fpfh_tpu.models.normals", "compute_normals"),
    "get_transform_from_conf_file": ("shot_fpfh_tpu.io.ground_truth", "get_transform_from_conf_file"),
    "check_transform": ("shot_fpfh_tpu.analysis", "check_transform"),
    "get_incorrect_matches": ("shot_fpfh_tpu.analysis", "get_incorrect_matches"),
    "plot_distance_hists": ("shot_fpfh_tpu.analysis", "plot_distance_hists"),
    "read_ply": ("shot_fpfh_tpu.io.ply", "read_ply"),
    "write_ply": ("shot_fpfh_tpu.io.ply", "write_ply"),
    "get_data": ("shot_fpfh_tpu.io.ply", "get_data"),
    "checkpoint": ("shot_fpfh_tpu.utils.perf", "checkpoint"),
    "timeit": ("shot_fpfh_tpu.utils.perf", "timeit"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "RigidTransform",
    "grid_subsample",
    "registration_rms",
    "rotation_angle",
    "solve_point_to_plane",
    "solve_point_to_point",
    "knn",
    "nearest_neighbor",
    "radius_count",
    "radius_search",
]
