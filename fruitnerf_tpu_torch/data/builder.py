"""Turn a scene into device-resident training data. Twin of
``fruitnerf_tpu/data/builder.py``: ``dataset_from_scene`` for a synthetic
scene (``data/synthetic.py``, re-exported here), ``dataset_from_parsed``
for a capture on disk (``data/dataparser.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .synthetic import SyntheticSceneConfig, cached_render_scene, render_scene  # noqa: F401

from .poses_io import load_image, load_mask
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


def cameras_from_parsed(parsed, device) -> Cameras:
    """The cameras of a ``dataparser.ParsedScene``: per-frame intrinsics and
    OpenCV distortion."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Cameras(
        camera_to_worlds=t(parsed.poses),
        fx=t(parsed.fx),
        fy=t(parsed.fy),
        cx=t(parsed.cx),
        cy=t(parsed.cy),
        width=t(parsed.width, torch.int64),
        height=t(parsed.height, torch.int64),
        distortion=t(parsed.distortion),
    )


def dataset_from_parsed(parsed, device) -> DeviceDataset:
    """From a ``dataparser.ParsedScene`` with images and masks on disk (all
    frames must share one resolution). Each frame becomes uint8 as it
    loads, as ``build_device_dataset`` would convert the whole float stack
    (``load_image``'s ``/ 255`` then ``* 255`` returns every uint8 value
    unchanged), so the host holds a quarter of the float stack."""
    images = np.stack([(np.clip(load_image(p), 0, 1) * 255).astype(np.uint8)
                       for p in parsed.image_paths])
    masks = np.stack([(load_mask(p) > 0.5).astype(np.uint8) for p in parsed.mask_paths])
    return build_device_dataset(images, masks, cameras_from_parsed(parsed, device),
                                parsed.train_indices, device)
