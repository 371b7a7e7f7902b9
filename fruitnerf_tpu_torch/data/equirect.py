"""Equirectangular -> perspective planar projections. Twin of
``fruitnerf_tpu/data/equirect.py`` (numpy, copied).

The reference converts 360 captures into N perspective views per
equirectangular frame before COLMAP (fruit_nerf_dataset.py:277-283, via
nerfstudio ``equirect_utils``). This is the standalone equivalent: a
vectorized spherical resampler (pure numpy — host-side preprocessing, not a
hot path) plus the view layout used by the CLI.

View layout (``images_per_equirect``):
  8  -> 8 views at yaw 0,45,...,315 deg, pitch 0
  14 -> those 8, plus 4 at pitch +45 (yaw 0/90/180/270), plus straight up
        and straight down

All views share a square 120-degree FOV. Output side length preserves the
equirect's angular resolution at the equator: ``side ~= width * fov/360``.
"""
from __future__ import annotations

import numpy as np

DEFAULT_FOV_DEG = 120.0


def view_directions(images_per_equirect: int) -> list[tuple[float, float]]:
    """(yaw_deg, pitch_deg) per view."""
    if images_per_equirect == 8:
        return [(y, 0.0) for y in range(0, 360, 45)]
    if images_per_equirect == 14:
        views = [(float(y), 0.0) for y in range(0, 360, 45)]
        views += [(float(y), 45.0) for y in range(0, 360, 90)]
        views += [(0.0, 90.0), (0.0, -90.0)]
        return views
    raise ValueError(
        f"images_per_equirect must be 8 or 14, got {images_per_equirect}"
    )


def perspective_size(equirect_width: int, fov_deg: float = DEFAULT_FOV_DEG) -> int:
    """Square output side that keeps equator angular resolution."""
    return max(8, int(round(equirect_width * fov_deg / 360.0)))


def equirect_to_perspective(
    equirect: np.ndarray,  # [H, W] or [H, W, C]
    yaw_deg: float,
    pitch_deg: float,
    fov_deg: float = DEFAULT_FOV_DEG,
    out_size: int | None = None,
    nearest: bool = False,
) -> np.ndarray:
    """Resample one perspective view out of an equirectangular image.

    Longitude 0 (image center column) is yaw 0; yaw increases to the right
    (east); pitch +90 is straight up. ``nearest=True`` for binary masks.
    """
    eq = np.asarray(equirect)
    squeeze = eq.ndim == 2
    if squeeze:
        eq = eq[..., None]
    h, w = eq.shape[:2]
    side = out_size or perspective_size(w, fov_deg)

    # pixel grid -> camera rays (pinhole, square fov)
    f = (side / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    xs = (np.arange(side) + 0.5) - side / 2.0
    ys = (np.arange(side) + 0.5) - side / 2.0
    u, v = np.meshgrid(xs, ys)
    # camera frame: +z forward, +x right, +y down (image convention)
    d = np.stack([u, -v, np.full_like(u, f)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    # rotate by pitch (about x) then yaw (about the world up axis)
    cp, sp = np.cos(np.radians(pitch_deg)), np.sin(np.radians(pitch_deg))
    cy, sy = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    # positive pitch tips the forward axis (+z) toward up (+y)
    rot_pitch = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
    rot_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    d = d @ (rot_yaw @ rot_pitch).T

    lon = np.arctan2(d[..., 0], d[..., 2])  # [-pi, pi], 0 = forward
    lat = np.arcsin(np.clip(d[..., 1], -1.0, 1.0))  # [-pi/2, pi/2], + = up

    # equirect coords: col 0 = lon -pi, row 0 = lat +pi/2 (north pole)
    fx = (lon / (2 * np.pi) + 0.5) * w - 0.5
    fy = (0.5 - lat / np.pi) * h - 0.5

    if nearest:
        ix = np.mod(np.round(fx).astype(np.int64), w)
        iy = np.clip(np.round(fy).astype(np.int64), 0, h - 1)
        out = eq[iy, ix]
    else:
        x0 = np.floor(fx).astype(np.int64)
        y0 = np.floor(fy).astype(np.int64)
        tx = (fx - x0)[..., None]
        ty = (fy - y0)[..., None]
        x0w, x1w = np.mod(x0, w), np.mod(x0 + 1, w)  # wrap longitude
        y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
        eqf = eq.astype(np.float64)
        out = (
            eqf[y0c, x0w] * (1 - tx) * (1 - ty)
            + eqf[y0c, x1w] * tx * (1 - ty)
            + eqf[y1c, x0w] * (1 - tx) * ty
            + eqf[y1c, x1w] * tx * ty
        )
        out = out.astype(eq.dtype) if np.issubdtype(eq.dtype, np.integer) else out.astype(eq.dtype)
    return out[..., 0] if squeeze else out


def generate_planar_projections(
    equirect: np.ndarray,
    images_per_equirect: int = 8,
    fov_deg: float = DEFAULT_FOV_DEG,
    out_size: int | None = None,
    nearest: bool = False,
) -> list[np.ndarray]:
    """All planar views of one equirectangular image, in layout order."""
    return [
        equirect_to_perspective(
            equirect, yaw, pitch, fov_deg=fov_deg, out_size=out_size, nearest=nearest
        )
        for yaw, pitch in view_directions(images_per_equirect)
    ]
