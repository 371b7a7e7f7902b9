"""transforms.json dataparser with semantic masks. Twin of
``fruitnerf_tpu/data/dataparser.py`` (numpy, copied; its images decode
through ``data/poses_io.py``).

Rebuild of the reference dataparser (fruit_nerf/data/fruitnerf_dataparser.py):
  * per-frame or global intrinsics fx/fy/cx/cy/h/w/k1-k4/p1-p2 (:86-137)
  * per-frame ``semantic_path`` fruit masks (:141-148)
  * split via explicit ``{split}_filenames`` or evenly spaced
    train_split_fraction (:157-186)
  * auto-orient (up) + center (poses) + auto-scale into the unit box
    (:188-207); scene AABB of +-scene_scale (:218-223)
  * honors ``applied_transform`` / ``applied_scale`` (:275-282)
  * auto-downscale so the longest side <= 1200px, reading pre-downscaled
    ``images_{2^k}/`` and ``semantics_{2^k}/`` folders (:39, :294-326)

Outputs a host-side ``ParsedScene`` plus the dataparser transform/scale that
the export path needs to un-normalize point clouds (exporter_utils.py:184-191).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from .poses_io import load_image, load_mask
from ..cameras.poses import auto_orient_and_center_poses, auto_scale_poses

MAX_AUTO_RESOLUTION = 1200  # fruitnerf_dataparser.py:39


@dataclasses.dataclass(frozen=True)
class DataParserConfig:
    data_dir: Path
    scale_factor: float = 1.0
    downscale_factor: int | None = None
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    semantics_classes: tuple = ("apple", "stuff")  # fruitnerf_dataparser.py:251


@dataclasses.dataclass
class ParsedScene:
    """Host-side parse result; arrays are numpy, images loaded lazily or eagerly."""

    image_paths: list
    mask_paths: list
    poses: np.ndarray  # [N, 3, 4] normalized
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray
    height: np.ndarray
    distortion: np.ndarray  # [N, 6]
    train_indices: np.ndarray
    eval_indices: np.ndarray
    dataparser_transform: np.ndarray  # [3, 4]
    dataparser_scale: float
    scene_aabb: np.ndarray  # [2, 3]
    semantics_classes: tuple

    def load_images(self, indices=None) -> np.ndarray:
        idx = range(len(self.image_paths)) if indices is None else indices
        return np.stack([load_image(self.image_paths[i]) for i in idx])

    def load_masks(self, indices=None) -> np.ndarray:
        idx = range(len(self.mask_paths)) if indices is None else indices
        return np.stack([load_mask(self.mask_paths[i]) for i in idx])


def _intrinsic(frame: dict, meta: dict, key: str, default=0.0) -> float:
    if key in frame:
        return float(frame[key])
    return float(meta.get(key, default))


def _downscale_factor(width: int, height: int, requested: int | None) -> int:
    """Auto-pick 2^k downscale so the longest side <= 1200px
    (fruitnerf_dataparser.py:294-326)."""
    if requested is not None:
        return requested
    factor = 1
    longest = max(width, height)
    while longest // (factor * 2) >= 1 and longest // factor > MAX_AUTO_RESOLUTION:
        factor *= 2
    return factor


def _resolve_path(data_dir: Path, rel: str, downscale: int, kind: str) -> Path:
    """Map a frame path to its downscaled folder (images_{k}/, semantics_{k}/)."""
    p = Path(rel)
    if downscale == 1:
        return data_dir / p
    parts = list(p.parts)
    # reference convention: images/ -> images_{k}/, semantics/.../ gets _{k}
    for i, part in enumerate(parts[:-1]):
        if part in ("images", "semantics", kind):
            parts[i] = f"{part}_{downscale}"
            break
    else:
        parts[0] = f"{parts[0]}_{downscale}"
    candidate = data_dir / Path(*parts)
    return candidate if candidate.exists() else data_dir / p


def parse_transforms(config: DataParserConfig) -> ParsedScene:
    data_dir = Path(config.data_dir)
    meta_path = (
        data_dir / "transforms.json" if data_dir.is_dir() else data_dir
    )
    if data_dir.is_file():
        data_dir = data_dir.parent
    with open(meta_path) as f:
        meta = json.load(f)

    frames = meta["frames"]
    # stable ordering by file path (reference sorts fnames)
    frames = sorted(frames, key=lambda fr: fr["file_path"])

    n = len(frames)
    poses = np.zeros((n, 4, 4), np.float64)
    fx = np.zeros(n)
    fy = np.zeros(n)
    cx = np.zeros(n)
    cy = np.zeros(n)
    width = np.zeros(n, np.int64)
    height = np.zeros(n, np.int64)
    distortion = np.zeros((n, 6))
    image_rel, mask_rel = [], []

    for i, frame in enumerate(frames):
        poses[i] = np.array(frame["transform_matrix"], np.float64)
        fx[i] = _intrinsic(frame, meta, "fl_x")
        fy[i] = _intrinsic(frame, meta, "fl_y")
        cx[i] = _intrinsic(frame, meta, "cx")
        cy[i] = _intrinsic(frame, meta, "cy")
        width[i] = int(_intrinsic(frame, meta, "w"))
        height[i] = int(_intrinsic(frame, meta, "h"))
        for j, k in enumerate(("k1", "k2", "k3", "k4", "p1", "p2")):
            distortion[i, j] = _intrinsic(frame, meta, k)
        image_rel.append(frame["file_path"])
        mask_rel.append(frame.get("semantic_path"))

    # splits: explicit {split}_filenames or evenly-spaced fraction
    # (fruitnerf_dataparser.py:157-186)
    fname_set = {Path(r).name: i for i, r in enumerate(image_rel)}
    if "train_filenames" in meta:
        train_idx = np.array(
            sorted(fname_set[Path(p).name] for p in meta["train_filenames"])
        )
        eval_names = meta.get("val_filenames", meta.get("test_filenames", []))
        eval_idx = np.array(
            sorted(fname_set[Path(p).name] for p in eval_names), dtype=np.int64
        )
    else:
        num_train = math.ceil(n * config.train_split_fraction)
        if num_train >= n:
            train_idx = np.arange(n)
            eval_idx = np.arange(min(1, n))  # degenerate: eval on first image
        else:
            train_idx = np.linspace(0, n - 1, num_train, dtype=np.int64)
            train_idx = np.unique(train_idx)
            eval_idx = np.setdiff1d(np.arange(n), train_idx)

    oriented, transform = auto_orient_and_center_poses(
        poses, method=config.orientation_method, center_method=config.center_method
    )
    scale = 1.0
    if config.auto_scale_poses:
        oriented, scale = auto_scale_poses(oriented)
    scale *= config.scale_factor

    # applied_transform / applied_scale from preprocessing
    # (fruitnerf_dataparser.py:275-282): the poses in transforms.json already
    # live in the preprocessed frame, so these compose into the REPORTED
    # dataparser transform/scale only — export un-normalization then maps
    # points all the way back to the original (pre-preprocessing) world frame,
    # keeping length-calibrated counting hyperparameters valid.
    if "applied_transform" in meta:
        at = np.array(meta["applied_transform"], np.float64)
        if at.shape == (3, 4):
            at = np.concatenate([at, [[0, 0, 0, 1]]], axis=0)
        t4 = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
        transform = (t4 @ at)[:3]
    if "applied_scale" in meta:
        scale *= float(meta["applied_scale"])

    aabb = np.array(
        [[-config.scene_scale] * 3, [config.scene_scale] * 3], np.float32
    )

    down = _downscale_factor(int(width.max()), int(height.max()), config.downscale_factor)
    image_paths = [_resolve_path(data_dir, r, down, "images") for r in image_rel]
    mask_paths = [
        _resolve_path(data_dir, r, down, "semantics") if r else None for r in mask_rel
    ]
    inv = 1.0 / down

    classes = tuple(meta.get("semantics", config.semantics_classes))

    return ParsedScene(
        image_paths=image_paths,
        mask_paths=mask_paths,
        poses=oriented.astype(np.float32),
        fx=(fx * inv).astype(np.float32),
        fy=(fy * inv).astype(np.float32),
        cx=(cx * inv).astype(np.float32),
        cy=(cy * inv).astype(np.float32),
        width=(width * inv).astype(np.int32),
        height=(height * inv).astype(np.int32),
        distortion=distortion.astype(np.float32),
        train_indices=train_idx.astype(np.int64),
        eval_indices=eval_idx.astype(np.int64),
        dataparser_transform=transform,
        dataparser_scale=float(scale),
        scene_aabb=aabb,
        semantics_classes=classes,
    )
