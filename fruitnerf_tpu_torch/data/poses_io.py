"""Image / binary-mask loading with the reference's normalization rules.
Twin of ``fruitnerf_tpu/data/poses_io.py``; images decode through Pillow,
as the twin's do.

Mask rule (fruit_dataset.py:48-55): jpg masks threshold at 125 -> {0,1};
otherwise a mask whose max exceeds 1 is divided by 255; a float mask already
in [0,1] passes through; anything else is an error.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def load_image(path: Path) -> np.ndarray:
    """[H, W, 3] float32 in [0,1]."""
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def load_mask(path: Path) -> np.ndarray:
    """[H, W] float32 binary fruit mask per the reference's rules."""
    arr = np.asarray(Image.open(path).convert("L"))
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        mask = (arr > 125).astype(np.float32)
    else:
        arr = arr.astype(np.float32)
        if arr.max() > 1.0:
            mask = arr / 255.0
        elif arr.max() <= 1.0:
            mask = arr
        else:  # pragma: no cover
            raise ValueError(f"unsupported mask value range in {path}")
    return mask.astype(np.float32)


def normalize_mask_array(arr: np.ndarray, is_jpg: bool = False) -> np.ndarray:
    """Array-level version of the mask rule (unit-testable without files)."""
    if is_jpg:
        return (arr > 125).astype(np.float32)
    arr = arr.astype(np.float32)
    if arr.max() > 1.0:
        return arr / 255.0
    return arr
