"""Point-cloud primitives for the counting stage (numpy + scipy cKDTree).

Replaces the Open3D C++ ops the reference leans on (clustering_base.py:183-207:
radius outlier removal, voxel downsample) — no Open3D in this image, and the
counting stage is host-side anyway (clouds are a few hundred K points after
downsampling).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean position per occupied voxel (matches open3d voxel_down_sample).
    Output rows ordered lexicographically by voxel key (np.unique order)."""
    if len(points) == 0:
        return points
    from .. import native

    res = native.voxel_downsample(np.asarray(points), voxel_size)
    if res is not None:
        # native emits hash order with the exact integer keys; lexsort on
        # those restores the key-lexicographic contract (re-deriving keys
        # from rounded float means can cross a voxel face)
        means, k = res
        return means[np.lexsort((k[:, 2], k[:, 1], k[:, 0]))]
    keys = np.floor(points / voxel_size).astype(np.int64)
    # lexicographic unique via structured view
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    n_vox = inverse.max() + 1
    sums = np.zeros((n_vox, 3), np.float64)
    np.add.at(sums, inverse, points)
    counts = np.bincount(inverse, minlength=n_vox)[:, None]
    return (sums / counts).astype(np.float32)


def radius_outlier_removal(
    points: np.ndarray, nb_points: int, radius: float, device="cuda"
) -> np.ndarray:
    """Keep points with >= nb_points neighbors within radius (incl. self),
    matching open3d remove_radius_outlier semantics. The native engine,
    then (>= 50k points) the device engine on ``device``, then the numpy
    grid engine, as ``dbscan`` dispatches."""
    if len(points) == 0:
        return points
    from .. import native

    mask = native.radius_outlier_mask(np.asarray(points), radius, nb_points)
    if mask is not None:
        return points[mask]
    if len(points) >= 50_000:
        from .dbscan_device import radius_neighbor_mask_device

        mask = radius_neighbor_mask_device(points, radius, nb_points, device)
        if mask is not None:
            return points[mask]
    from .gridhash import neighbor_counts

    counts = neighbor_counts(points, radius)
    return points[counts >= nb_points]


def hausdorff_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric Hausdorff distance (the reference scores template fits with
    the numba `hausdorff` package, clustering_base.py:17,277,315)."""
    if len(a) == 0 or len(b) == 0:
        return np.inf
    d_ab = cKDTree(b).query(a, workers=-1)[0].max()
    d_ba = cKDTree(a).query(b, workers=-1)[0].max()
    return float(max(d_ab, d_ba))


def convex_hull_volume(points: np.ndarray) -> float:
    """Cluster volume proxy. The reference uses alphashape(alpha=10) volumes
    (clustering_base.py:321-343); its split/prune decisions only compare
    volume RATIOS against the template (0.9x / 0.3x), for which the convex
    hull is an adequate, dependency-free surrogate (alphashape at alpha=10 on
    fruit-sized blobs is near-convex)."""
    if len(points) < 4:
        return 0.0
    from scipy.spatial import ConvexHull, QhullError

    try:
        return float(ConvexHull(points).volume)
    except QhullError:
        return 0.0
