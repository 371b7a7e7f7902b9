"""Turn a scene into device-resident training data. Twin of
``fruitnerf_tpu/data/builder.py`` (``dataset_from_scene``; the on-disk
``dataset_from_parsed`` is still to port).

Scenes come from ``data/synthetic.py`` (re-exported here).
"""
from __future__ import annotations

import numpy as np
import torch

from .synthetic import SyntheticSceneConfig, cached_render_scene, render_scene  # noqa: F401

from ..cameras.cameras import Cameras
from ..engine.trainer import DeviceDataset, build_device_dataset


def cameras_from_scene(scene: dict, device) -> Cameras:
    """scene: a ``render_scene`` dict (or an equivalent one)."""
    n = scene["poses"].shape[0]

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=device)

    return Cameras(
        camera_to_worlds=torch.as_tensor(np.asarray(scene["poses"], np.float32), device=device),
        fx=full(float(scene["fx"])),
        fy=full(float(scene["fy"])),
        cx=full(float(scene["cx"])),
        cy=full(float(scene["cy"])),
        width=full(int(scene["width"]), torch.int64),
        height=full(int(scene["height"]), torch.int64),
        distortion=torch.zeros((n, 6), device=device),
    )


def train_indices_for(num_images: int, train_fraction: float = 0.9) -> np.ndarray:
    """Evenly spaced training cameras; the rest are held out."""
    num_train = max(1, int(np.ceil(num_images * train_fraction)))
    if num_train >= num_images:
        return np.arange(num_images)
    return np.unique(np.linspace(0, num_images - 1, num_train, dtype=np.int64))


def dataset_from_scene(scene: dict, device, train_fraction: float = 0.9) -> DeviceDataset:
    train_idx = train_indices_for(scene["images"].shape[0], train_fraction)
    return build_device_dataset(
        scene["images"], scene["masks"], cameras_from_scene(scene, device), train_idx, device
    )
