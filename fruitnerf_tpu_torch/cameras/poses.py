"""Pose normalization: auto-orient (up), auto-center, auto-scale. Twin of
``fruitnerf_tpu/cameras/poses.py`` (numpy, copied).

The reference dataparser orients poses by the mean up-vector, centers on the
mean camera position, and scales translations so cameras fit the unit box
(fruitnerf_dataparser.py:188-207, `orientation_method="up"`,
`center_method="poses"`, `auto_scale_poses=True`). These run once on the host
at parse time, in numpy (float64, cast to float32 at the end).
"""
from __future__ import annotations

import numpy as np


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        if c > 0:
            return np.eye(3)
        # 180 degrees: rotate around any axis orthogonal to a
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis = axis / np.linalg.norm(axis)
        k = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        return np.eye(3) + 2.0 * k @ k
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> tuple[np.ndarray, np.ndarray]:
    """poses: [N, 4, 4] or [N, 3, 4] camera-to-world.

    Returns (oriented_poses [N,3,4], transform [3,4]) with world +z aligned to
    the mean camera up vector and translations centered.
    """
    poses = np.asarray(poses, dtype=np.float64)
    if poses.shape[-2] == 4:
        poses = poses[:, :3, :]
    origins = poses[:, :3, 3]

    if center_method == "poses":
        translation = origins.mean(axis=0)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unknown orientation method {method!r}")

    transform = np.concatenate(
        [rotation, rotation @ -translation[:, None]], axis=-1
    )  # [3,4]
    ones = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), (poses.shape[0], 1, 4))
    poses_h = np.concatenate([poses, ones], axis=1)  # [N,4,4]
    oriented = np.einsum("ij,njk->nik", transform, poses_h)  # [N,3,4]
    return oriented.astype(np.float32), transform.astype(np.float32)


def auto_scale_poses(poses: np.ndarray) -> tuple[np.ndarray, float]:
    """Scale translations so all cameras fit in the unit box; returns
    (poses, scale_factor). The scale is persisted in the run manifest because
    export un-normalization depends on it (exporter_utils.py:184-191)."""
    poses = np.array(poses, copy=True)
    scale = float(1.0 / max(np.abs(poses[:, :3, 3]).max(), 1e-12))
    poses[:, :3, 3] *= scale
    return poses, scale
