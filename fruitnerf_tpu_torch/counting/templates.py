"""Procedural fruit template point clouds.

The reference ships apple/lemon/peach/pear templates as git-lfs .ply files
that are unresolved pointer stubs in the snapshot (SURVEY.md: 130-byte
stubs, .gitattributes:18-21), so templates are regenerated here as
parametric surface point clouds (superellipsoid-style profiles per fruit).
Template usage downstream matches the reference (run_clustering.py:40-47):
scaled by the profile's ``template_size``, centered, hull volume precomputed.
"""
from __future__ import annotations

import numpy as np

# (vertical half-axis ratio, equator bulge exponent, dimple depth)
_PROFILES = {
    "sphere": (0.5, 1.0, 0.0),  # synthetic orchard fruits are spheres
    "apple": (0.45, 1.0, 0.12),
    "pear": (0.62, 1.6, 0.0),
    "plum": (0.42, 1.0, 0.06),
    "lemon": (0.55, 1.2, -0.08),  # pointed ends
    "peach": (0.46, 1.0, 0.10),
    "mango": (0.60, 1.4, 0.0),
}
# base equatorial radius in scene units (exported clouds are x2-unscaled,
# exporter_utils.py:191); profiles rescale via template_size
BASE_RADIUS = 0.04


def fruit_template(
    kind: str = "apple",
    num_points: int = 2048,
    radius: float = BASE_RADIUS,
    seed: int = 0,
) -> np.ndarray:
    """[N, 3] surface point cloud of a fruit shape, centered at the origin."""
    if kind not in _PROFILES:
        raise KeyError(f"unknown template {kind!r}; choose from {sorted(_PROFILES)}")
    half_h, bulge, dimple = _PROFILES[kind]
    rng = np.random.RandomState(seed)
    # fibonacci sphere for even coverage
    i = np.arange(num_points)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / num_points
    theta = golden * i
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    x = np.cos(theta) * r_xy
    y = np.sin(theta) * r_xy

    # fruit profile: equatorial radius modulated by latitude; unit xy along
    # the fibonacci azimuths, height scaled by the fruit's half-axis ratio
    lat = z  # [-1, 1]
    profile = np.maximum(1.0 - np.abs(lat) ** (2.0 * bulge), 0.0) ** 0.5
    azim = np.stack([x, y], -1) / np.maximum(r_xy, 1e-9)[:, None]
    pts = np.concatenate(
        [azim * profile[:, None], (lat * 2.0 * half_h)[:, None]], axis=-1
    )
    # dimples at poles (apple/peach) or pointed ends (lemon, negative dimple)
    pole = np.abs(lat) > 0.85
    pts[pole, 2] -= (
        np.sign(pts[pole, 2]) * dimple * (np.abs(lat[pole]) - 0.85) / 0.15 * half_h
    )
    pts *= radius
    pts += rng.normal(0, radius * 0.005, pts.shape)  # slight surface noise
    return (pts - pts.mean(axis=0)).astype(np.float32)


def load_or_make_template(
    template: str | np.ndarray, template_size: float = 1.0, num_points: int = 2048
) -> np.ndarray:
    """Resolve a template spec: array, named kind, or .ply path; scale and
    center it (run_clustering.py:40-47)."""
    if isinstance(template, np.ndarray):
        pts = template.astype(np.float32)
    elif isinstance(template, str) and template.endswith(".ply"):
        from ..export.ply import read_ply

        pts = read_ply(template)["points"]
    else:
        pts = fruit_template(str(template), num_points=num_points)
    pts = pts * float(template_size)
    return pts - pts.mean(axis=0)
