"""DBSCAN via cKDTree neighborhoods + BFS expansion.

Self-contained replacement for sklearn's DBSCAN (clustering_base.py:13,200),
matching its semantics: a core point has >= min_samples neighbors within eps
(self included); clusters grow from core points; border points join the first
core cluster that reaches them; everything else is noise (-1).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def dbscan(points: np.ndarray, eps: float, min_samples: int, device="cuda") -> np.ndarray:
    """[N,3] -> labels [N] int32 (-1 = noise).

    Dispatch: the native C++ grid engine (fruitnerf_tpu_torch/native) handles
    any size on the host; without it, export-scale clouds (>= 50k points) go
    to the device engine (counting/dbscan_device.py, the quadratic neighbor
    math as batched tensor math on ``device``, the card unless the caller
    names the CPU), and smaller ones to the numpy grid engine
    (counting/gridhash.py). All are exact; the BFS version remains the
    reference implementation and the fallback for degenerate spreads."""
    from .. import native

    labels = native.dbscan(np.asarray(points), eps, min_samples)
    if labels is not None:
        return labels
    if len(points) >= 50_000:
        from .dbscan_device import dbscan_device

        labels = dbscan_device(points, eps, min_samples, device)
        if labels is not None:
            return labels
    from .gridhash import dbscan_grid

    return dbscan_grid(points, eps, min_samples)


def dbscan_bfs(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """[N,3] -> labels [N] int32 (-1 = noise)."""
    n = len(points)
    labels = np.full(n, -1, np.int32)
    if n == 0:
        return labels
    tree = cKDTree(points)
    neighborhoods = tree.query_ball_point(points, eps, workers=-1)
    counts = np.fromiter((len(nb) for nb in neighborhoods), np.int64, count=n)
    core = counts >= min_samples

    cluster = 0
    visited = np.zeros(n, bool)
    for seed in range(n):
        if visited[seed] or not core[seed]:
            continue
        # BFS from this core point
        stack = [seed]
        visited[seed] = True
        labels[seed] = cluster
        while stack:
            p = stack.pop()
            if not core[p]:
                continue  # border point: labeled but not expanded
            for q in neighborhoods[p]:
                if labels[q] == -1:
                    labels[q] = cluster
                if not visited[q]:
                    visited[q] = True
                    if core[q]:
                        stack.append(q)
        cluster += 1
    return labels
