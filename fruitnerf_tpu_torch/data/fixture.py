"""Materialize a synthetic scene as an on-disk capture in the reference's
dataset layout. Twin of ``fruitnerf_tpu/data/fixture.py``
(``write_scene_capture``). The layout is (README.md:166-224): an images folder, a matching binary-mask
folder, and a COLMAP-style ``transforms.json`` with global intrinsics and
per-frame ``transform_matrix`` poses.

This is the bridge between the in-process procedural scenes (data/synthetic)
and the DISK pipeline the reference documents — ``process-data`` ingestion,
downscale pyramids, the dataparser's orient/center/scale, and the
manifest-driven export un-normalization all run exactly as they would on a
real COLMAP output tree. Used by the disk end-to-end tests
(tests/test_torch_disk_e2e.py) and chip_smoke.py's disk phase.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from PIL import Image


def write_scene_capture(
    scene: dict,
    root: Path | str,
    eval_fraction: float = 0.0,
    applied_scale: float | None = None,
) -> Path:
    """Write ``scene`` (data/synthetic.render_scene output) under ``root`` as

        root/images/frame_00000.png ...
        root/masks/frame_00000.png  (binary 0/255, fruit_dataset.py:48-55)
        root/transforms.json        (global fl_x/fl_y/cx/cy/w/h + k1..p2,
                                     per-frame file_path/semantic_path/
                                     transform_matrix — the schema
                                     fruitnerf_dataparser.py:86-148 consumes)

    ``eval_fraction`` > 0 also writes explicit train/val split filename lists
    (the ``{split}_filenames`` mechanism, fruitnerf_dataparser.py:157-186).
    Returns the transforms.json path.
    """
    root = Path(root)
    img_dir = root / "images"
    mask_dir = root / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)

    images = np.asarray(scene["images"])
    masks = np.asarray(scene["masks"])
    poses = np.asarray(scene["poses"])  # [N, 3, 4]
    n = images.shape[0]

    frames = []
    names = []
    for i in range(n):
        name = f"frame_{i:05d}.png"
        names.append(name)
        Image.fromarray((np.clip(images[i], 0, 1) * 255).astype(np.uint8)).save(img_dir / name)
        Image.fromarray(((masks[i] > 0.5) * 255).astype(np.uint8)).save(mask_dir / name)
        tm = np.eye(4, dtype=np.float64)
        tm[:3] = poses[i]
        frames.append(
            {
                "file_path": f"images/{name}",
                "semantic_path": f"masks/{name}",
                "transform_matrix": tm.tolist(),
            }
        )

    meta = {
        "fl_x": float(scene["fx"]),
        "fl_y": float(scene["fy"]),
        "cx": float(scene["cx"]),
        "cy": float(scene["cy"]),
        "w": int(scene["width"]),
        "h": int(scene["height"]),
        "k1": 0.0,
        "k2": 0.0,
        "p1": 0.0,
        "p2": 0.0,
        "camera_model": "OPENCV",
        "semantics": ["apple", "stuff"],  # fruitnerf_dataparser.py:251
        "frames": frames,
    }
    if applied_scale is not None:
        meta["applied_scale"] = float(applied_scale)
    if eval_fraction > 0:
        n_eval = max(1, int(round(n * eval_fraction)))
        eval_idx = set(
            np.linspace(0, n - 1, n_eval, dtype=np.int64).tolist()
        )
        meta["train_filenames"] = [
            f"images/{nm}" for i, nm in enumerate(names) if i not in eval_idx
        ]
        meta["val_filenames"] = [
            f"images/{nm}" for i, nm in enumerate(names) if i in eval_idx
        ]
    path = root / "transforms.json"
    path.write_text(json.dumps(meta, indent=1))
    return path
