from .eigh3 import eigh3x3, pca_eigh
from .neighbors import (
    Neighborhoods,
    knn,
    nearest_neighbor,
    radius_count,
    radius_search,
)
from .grid_hash import set_window_group, window_group_default

__all__ = [
    "eigh3x3",
    "pca_eigh",
    "set_window_group",
    "window_group_default",
    "Neighborhoods",
    "knn",
    "nearest_neighbor",
    "radius_count",
    "radius_search",
]
