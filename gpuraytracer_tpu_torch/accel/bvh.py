"""Instance clustering — the two-level bounds hierarchy of the layout.

Port (a numpy copy) of gpuraytracer_tpu/accel/bvh.py. Instances are
grouped host-side by recursive median split over their AABB centroids;
the reference's TPU tile kernels test one merged slab per cluster before
its members. Clusters are conservative gates: every member keeps its own
slab gate, so a traversal that skips the cluster test renders the same
image. The port's CUDA kernels skip it (one thread per ray tests each
member's slab directly); the layout still carries the clusters.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# Closed-form scenes at or below this many instances stay flat.
FLAT_THRESHOLD = 16
# March-kind instances (SDF, metaballs) cluster above this count.
MARCH_FLAT_THRESHOLD = 7
DEFAULT_LEAF_SIZE = 8
MARCH_LEAF_SIZE = 4


def build_clusters(aabb_min: np.ndarray, aabb_max: np.ndarray,
                   leaf_size: int = DEFAULT_LEAF_SIZE) -> Tuple[Tuple[int, ...], ...]:
    """Recursive median split over AABB centroids: a partition of
    range(N) into spatially compact clusters of at most leaf_size."""
    aabb_min = np.asarray(aabb_min, dtype=np.float64)
    aabb_max = np.asarray(aabb_max, dtype=np.float64)
    centroids = (aabb_min + aabb_max) * 0.5

    def split(idx: np.ndarray) -> list:
        if idx.size <= leaf_size:
            return [tuple(int(i) for i in idx)]
        spans = centroids[idx].max(axis=0) - centroids[idx].min(axis=0)
        axis = int(np.argmax(spans))
        order = idx[np.argsort(centroids[idx, axis], kind="stable")]
        half = idx.size // 2
        return split(order[:half]) + split(order[half:])

    return tuple(split(np.arange(aabb_min.shape[0])))


def cluster_aabbs(clusters: Sequence[Sequence[int]], aabb_min, aabb_max):
    """Merged (min, max) AABB per cluster."""
    mins = np.stack([np.min(np.asarray(aabb_min)[list(c)], axis=0) for c in clusters])
    maxs = np.stack([np.max(np.asarray(aabb_max)[list(c)], axis=0) for c in clusters])
    return mins, maxs


def should_cluster(num_instances: int, march_kinds: int = 0) -> bool:
    return num_instances > FLAT_THRESHOLD or march_kinds > MARCH_FLAT_THRESHOLD


def leaf_size_for(num_instances: int) -> int:
    return MARCH_LEAF_SIZE if num_instances <= FLAT_THRESHOLD else DEFAULT_LEAF_SIZE
