"""Stock RGB point-cloud export: depth-backprojected surface points. Twin
of ``fruitnerf_tpu/export/rgb_pointcloud.py``.

The reference CLI exposes nerfstudio's stock ``pointcloud`` subcommand next
to the semantic exporter (exporter.py:124-129). This is its equivalent:
render each camera through the chunked eval path
(``engine/trainer.render_camera``), back-project per-ray expected depth into
world space, keep rays whose accumulation says they hit geometry, and write
an RGB-colored .ply. Outliers are cleaned with the native radius-outlier
engine (Open3D's role in nerfstudio's exporter), or the numpy grid engine
where the native library is missing.
"""
from __future__ import annotations

import numpy as np

from ..cameras.cameras import generate_image_rays
from ..engine.trainer import render_camera


def backproject_camera(
    cameras, camera_index: int, depth: np.ndarray, rgb: np.ndarray,
    accumulation: np.ndarray, acc_threshold: float = 0.5,
):
    """One rendered camera -> (points [M,3], colors [M,3]) world-space, as
    numpy.

    depth is the expected termination distance along the (unit-normalized)
    ray direction, as produced by the depth renderer.
    """
    h, w = depth.shape
    bundle = generate_image_rays(cameras, camera_index, h, w)
    origins = bundle.origins.cpu().numpy().reshape(h, w, 3)
    dirs = bundle.directions.cpu().numpy().reshape(h, w, 3)
    keep = np.asarray(accumulation) >= acc_threshold
    pts = origins[keep] + dirs[keep] * np.asarray(depth)[keep][..., None]
    cols = np.clip(np.asarray(rgb)[keep], 0.0, 1.0)
    return pts.astype(np.float32), cols.astype(np.float32)


def export_rgb_pointcloud(
    params, config, cameras, camera_indices, *,
    num_points: int = 1_000_000, acc_threshold: float = 0.5,
    outlier_nb_points: int = 8, outlier_radius_factor: float = 4.0,
    dataparser_scale: float = 1.0, seed: int = 0,
):
    """Render cameras -> merged cleaned RGB cloud in un-normalized world
    coordinates (same 1/scale x2 convention as the semantic exporter,
    exporter_utils.py:184-191). ``params`` is the whole parameter dict (its
    ``"model"`` renders), on the device the cameras are on.

    Returns (points [M,3], colors [M,3]) as numpy.
    """
    all_pts, all_cols = [], []
    for ci in camera_indices:
        panels = render_camera(params, cameras, int(ci), config)
        pts, cols = backproject_camera(
            cameras, int(ci), panels["depth"].cpu().numpy(),
            panels["rgb"].cpu().numpy(), panels["accumulation"].cpu().numpy(),
            acc_threshold,
        )
        all_pts.append(pts)
        all_cols.append(cols)
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(all_cols) if all_cols else np.zeros((0, 3), np.float32)

    if len(pts) > num_points:
        rng = np.random.RandomState(seed)
        sel = rng.choice(len(pts), num_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    if len(pts) > 0 and outlier_nb_points > 1:
        # radius scaled to sampling density: median nearest-neighbor spacing
        from .. import native
        from ..counting.gridhash import neighbor_counts

        sub = pts[:: max(1, len(pts) // 2000)]
        d2 = ((sub[None] - sub[:, None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        spacing = float(np.median(np.sqrt(d2.min(1))))
        radius = outlier_radius_factor * spacing
        counts = native.neighbor_counts(pts, radius)
        if counts is None:
            counts = neighbor_counts(pts, radius)
        mask = counts >= outlier_nb_points
        pts, cols = pts[mask], cols[mask]

    pts = pts * (1.0 / dataparser_scale) * 2.0
    return pts, cols
