"""Offline render CLI — minimum-parity replacement for the reference's viewer
and render shims (debug/render.py, debug/viewer.py). Twin of
``fruitnerf_tpu/scripts/render.py``: renders cameras of a trained run to PNG
panels (rgb / depth / accumulation / semantics / colormap).

    python -m fruitnerf_tpu_torch render --load-dir runs/my_run --data synthetic \\
        --output-dir renders/ --cameras 0 1 2

Unlike the twin, the run's config is rebuilt with its manifest's
``config_overrides`` (as ``eval`` and ``export`` do), so a run trained with
a shape-changing override restores, and a capture is parsed at the run's
``--downscale-factor``. It runs on the card unless ``--device cpu`` asks for
the CPU; ``--mesh`` splits each camera's rays over every visible card.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--load-dir", required=True)
    p.add_argument("--data", required=True, help="dataset dir or 'synthetic'")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--cameras", type=int, nargs="*", default=[0])
    p.add_argument(
        "--mesh", action="store_true",
        help="shard each camera's rays over all visible devices",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def _save(arr, path):
    """A panel as an RGB PNG; a 2-D panel min-max scaled to [0, 1] first."""
    from PIL import Image

    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-9)
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, -1)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def main(args):
    import torch

    from ..engine.runs import load_run, parse_capture
    from ..engine.trainer import render_camera
    from ..utils import mesh_devices, resolve_device

    dev = resolve_device(args.device)
    devices = mesh_devices(dev) if args.mesh else None
    manifest, config, state = load_run(args.load_dir, dev)

    if args.data == "synthetic":
        from ..data.builder import cameras_from_scene
        from ..data.synthetic import SyntheticSceneConfig, render_scene

        cameras = cameras_from_scene(
            render_scene(SyntheticSceneConfig(num_cameras=24, image_size=128), device=dev), dev)
    else:
        from ..data.builder import cameras_from_parsed

        cameras = cameras_from_parsed(parse_capture(args.data, manifest), dev)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for ci in args.cameras:
        panels = render_camera(state.params, cameras, ci, config, devices)
        panels["semantics"] = torch.sigmoid(panels["semantics"][..., 0])
        for key, name in (("rgb", "rgb"), ("depth", "depth"), ("accumulation", "acc"),
                          ("semantics", "semantics"), ("semantics_colormap", "colormap")):
            path = out / f"cam{ci:03d}_{name}.png"
            _save(panels[key].float().cpu().numpy(), path)
            written.append(path)
        print(f"rendered camera {ci} -> {out}")
    return written
