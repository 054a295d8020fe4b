"""Ground-truth-driven match analysis (reference analysis/matches_analysis.py).

Plot-producing helpers return the histogram *data*; rendering is optional and
headless-gated so the pipeline runs on display-less hosts.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .core.transform import RigidTransform
from .ops.neighbors import nearest_neighbor
from .registration.matching import top2_descriptor


def get_incorrect_matches(scan, ref, exact_transformation: RigidTransform) -> np.ndarray:
    """Match wrong iff the exactly-transformed scan point is > 1e-2 from its
    matched ref point (reference matches_analysis.py:14-32)."""
    moved = np.asarray(exact_transformation.apply(jnp.asarray(scan, jnp.float32)))
    return np.linalg.norm(moved - np.asarray(ref), axis=1) > 1e-2


def lowe_ratio_split(
    scan, ref, exact_transformation: RigidTransform, scan_descriptors, ref_descriptors
):
    """Ratio (d1/d2) histogram data split by correct/incorrect matches — the
    data behind the reference's ``plot_distance_hists``
    (matches_analysis.py:35-88).  Returns (correct_ratios, incorrect_ratios)."""
    moved = exact_transformation.apply(jnp.asarray(scan, jnp.float32))
    dist_points, indices_points = nearest_neighbor(moved, jnp.asarray(ref, jnp.float32))

    idx1, d1, d2 = top2_descriptor(
        jnp.asarray(scan_descriptors, jnp.float32),
        jnp.asarray(ref_descriptors, jnp.float32),
        jnp.ones(len(ref_descriptors), bool),
    )
    idx1, d1, d2 = np.asarray(idx1), np.asarray(d1), np.asarray(d2)
    correct = (idx1 == np.asarray(indices_points)) & (np.asarray(dist_points) < 1e-2)
    ratios = np.divide(d1, d2, out=np.ones_like(d1), where=d2 > 0)
    return ratios[correct], ratios[~correct]


def check_transform(scan, ref, transformation: RigidTransform, bins: int = 100):
    """NN-distance histogram under a candidate transform (reference
    ``check_transform``, ground_truth_retrieval.py:51-61); renders when
    matplotlib is available, always returns the histogram data."""
    from .io.ground_truth import nn_distance_histogram

    counts, edges = nn_distance_histogram(scan, ref, transformation, bins)
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.hist(edges[:-1], bins=edges, weights=counts)
        plt.savefig("check_transform.png")
        plt.close()
    except ImportError:
        pass
    return counts, edges


def plot_distance_hists(scan, ref, exact_transformation, scan_descriptors, ref_descriptors):
    """Render the ratio histograms when matplotlib + display are available."""
    correct, incorrect = lowe_ratio_split(
        scan, ref, exact_transformation, scan_descriptors, ref_descriptors
    )
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        return correct, incorrect
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8))
    ax1.hist(correct, bins=50, label="Correct matches")
    ax2.hist(incorrect, bins=50, label="Incorrect matches")
    for ax in (ax1, ax2):
        ax.legend()
        ax.set(title="Ratio between the nearest neighbor and the second nearest one")
    fig.savefig("distance_hists.png")
    plt.close(fig)
    return correct, incorrect


def plot_neighborhood_sizes(sizes, output_path: str = "neighborhood_sizes.png"):
    """Neighborhood-size distribution: logs mean/std/min/max and renders the
    histogram when matplotlib is available (reference
    ``compute_pca_based_features``'s inline plot,
    pca_based_descriptors.py:105-119).  Always returns ``(counts, edges)``."""
    import logging

    sizes = np.asarray(sizes).reshape(-1)
    logging.getLogger(__name__).info(
        "Average size of neighborhoods: %.4f (std %.4f, min %d, max %d)",
        float(np.mean(sizes)), float(np.std(sizes)),
        int(np.min(sizes)), int(np.max(sizes)),
    )
    counts, edges = np.histogram(sizes, bins="auto")
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        return counts, edges
    plt.hist(edges[:-1], bins=edges, weights=counts)
    plt.title(f"Histogram of the neighborhood sizes for {len(counts)} bins")
    plt.xlabel("Neighborhood size")
    plt.ylabel("Number of neighborhoods")
    plt.savefig(output_path)
    plt.close()
    return counts, edges
