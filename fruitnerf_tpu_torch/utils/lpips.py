"""LPIPS (learned perceptual image patch similarity), forward only. Twin of
``fruitnerf_tpu/utils/lpips.py``: the same ``.npz`` schema and formula, with
``F.conv2d`` and ``F.max_pool2d`` for the JAX package's XLA convolutions
(no Pallas kernel there). It runs on the images' device.

The reference evaluates LPIPS via torchmetrics with pretrained VGG/AlexNet
weights (fruit_nerf.py:16,177,425). Nothing here downloads them: the
*weights* are supplied by the user; the *computation*, Zhang et al. 2018:

  1. map inputs from [0,1] to [-1,1] (torchmetrics ``normalize=True``)
  2. per-channel shift/scale whitening
  3. VGG-style backbone: stages of (3x3 conv, pad 1) + ReLU, with 2x2/2
     max-pool between stages; the activation AFTER the last ReLU of each
     stage is a feature tap
  4. unit-normalize each tap across channels
  5. squared difference -> 1x1 "lin" conv (non-negative weights) -> spatial
     mean -> sum over stages

Expected ``.npz`` schema (all arrays in torch conv layout ``[out,in,kh,kw]``,
biases ``[out]``):

  shift                 [3]   per-channel whitening shift (e.g. VGG
  scale                 [3]   -.030/-.088/-.188 and .458/.448/.450)
  stage{s}_conv{j}_w    conv weight, s = 0..S-1, j = 0..(convs in stage)-1
  stage{s}_conv{j}_b    conv bias
  lin{s}_w              [1,C_s,1,1] (or [C_s]) LPIPS linear head per stage

``fruitnerf_tpu/utils/lpips.py``'s docstring shows how to export the
official ``lpips`` package's VGG into it.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def load_lpips_weights(weights_path) -> dict:
    """Parse the npz into {shift, scale, stages: [[(w,b),...]], lins: [w]}
    (float32 CPU tensors)."""
    with np.load(weights_path) as z:
        raw = dict(z)
    stage_keys = sorted(
        (int(m.group(1)), int(m.group(2)))
        for k in raw
        if (m := re.fullmatch(r"stage(\d+)_conv(\d+)_w", k))
    )
    if not stage_keys:
        raise ValueError(
            f"{weights_path}: no 'stage{{s}}_conv{{j}}_w' arrays found; see "
            "fruitnerf_tpu_torch.utils.lpips docstring for the expected npz schema"
        )

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    num_stages = max(s for s, _ in stage_keys) + 1
    stages = [
        [(t(raw[f"stage{s}_conv{j}_w"]), t(raw[f"stage{s}_conv{j}_b"]))
         for j in range(max(j for u, j in stage_keys if u == s) + 1)]
        for s in range(num_stages)
    ]
    lins = [t(raw[f"lin{s}_w"]).reshape(-1) for s in range(num_stages)]
    shift = t(raw.get("shift", np.zeros(3))).reshape(1, 3, 1, 1)
    scale = t(raw.get("scale", np.ones(3))).reshape(1, 3, 1, 1)
    return {"stages": stages, "lins": lins, "shift": shift, "scale": scale}


def _features(x, stages):
    """Feature taps after each stage's final ReLU (maxpool between stages)."""
    taps = []
    for s, convs in enumerate(stages):
        if s > 0:
            x = F.max_pool2d(x, 2, 2)
        for w, b in convs:
            x = F.relu(F.conv2d(x, w, b, padding=(w.shape[2] // 2, w.shape[3] // 2)))
        taps.append(x)
    return taps


def _unit_normalize(x, eps=1e-10):
    return x / torch.sqrt(torch.sum(x**2, dim=1, keepdim=True) + eps)


@torch.no_grad()
def lpips_fn(pred, target, weights) -> torch.Tensor:
    """LPIPS on [N,3,H,W] or [H,W,3] inputs in [0,1] (tensors or arrays),
    given parsed weights; a 0-d float32 tensor on the inputs' device."""
    dev = pred.device if isinstance(pred, torch.Tensor) else torch.device("cpu")

    def to_nchw(img):
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        if img.ndim == 3:  # [H,W,3]
            img = img.permute(2, 0, 1)[None]
        return img

    shift, scale = weights["shift"].to(dev), weights["scale"].to(dev)
    stages = [[(w.to(dev), b.to(dev)) for w, b in convs] for convs in weights["stages"]]
    # [0,1] -> [-1,1] (torchmetrics normalize=True), then whitening
    p = (2.0 * to_nchw(pred) - 1.0 - shift) / scale
    t = (2.0 * to_nchw(target) - 1.0 - shift) / scale
    # the convolutions in float32, as the reference's: cuDNN would take TF32
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        taps = list(zip(_features(p, stages), _features(t, stages)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    total = 0.0
    for (fp, ft), lw in zip(taps, weights["lins"]):
        d = (_unit_normalize(fp) - _unit_normalize(ft)) ** 2
        # 1x1 non-negative lin conv == channel-weighted sum
        per_pixel = torch.einsum("nchw,c->nhw", d, lw.to(dev))
        total = total + per_pixel.mean(dim=(1, 2))
    return total.mean()


@functools.lru_cache(maxsize=2)
def _cached_weights(path_str: str):
    return load_lpips_weights(path_str)


def lpips(pred, target, weights_path: str | Path | None = None) -> float:
    """LPIPS distance between two images in [0,1].

    ``weights_path`` points at an npz of backbone + lin-head weights (schema
    in the module docstring). Without weights LPIPS cannot be computed
    faithfully offline: raises with guidance (the reference's torchmetrics
    LPIPS downloads pretrained VGG at import, fruit_nerf.py:177)."""
    if weights_path is None:
        raise NotImplementedError(
            "LPIPS needs pretrained backbone weights, which nothing here downloads. "
            "Provide weights_path (npz; schema in fruitnerf_tpu_torch.utils.lpips "
            "docstring) or use psnr/ssim/iou from fruitnerf_tpu_torch.utils.metrics."
        )
    return float(lpips_fn(pred, target, _cached_weights(str(weights_path))))
