"""Full-eval-set metrics CLI — the ``ns-eval`` /
``get_average_eval_image_metrics`` analog (fruit_pipeline.py:176-227). Twin
of ``fruitnerf_tpu/scripts/evaluate.py``: loads a trained run, renders every
eval camera, and reports averaged PSNR / SSIM / IoU (+ LPIPS with weights)
plus rays/sec and fps.

    python -m fruitnerf_tpu_torch eval --load-dir runs/my_run --data <dir> \\
        --output results.json

The capture is parsed again at the run's split and ``--downscale-factor``
(both in its manifest; the twin re-parses at the automatic factor). It runs
on the card unless ``--device cpu`` asks for the CPU; ``--mesh`` splits each
camera's rays over every visible card (``utils.mesh_devices``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--load-dir", required=True)
    p.add_argument("--data", required=True, help="dataset dir or 'synthetic'")
    p.add_argument("--output", default=None, help="write metrics JSON here")
    p.add_argument("--split", default="eval", choices=["eval", "train", "all"])
    p.add_argument("--lpips-weights", default=None,
                   help="npz of LPIPS backbone weights (utils/lpips.py schema)")
    p.add_argument(
        "--mesh", action="store_true",
        help="shard each camera's rays over all visible devices",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def main(args):
    from ..engine.runs import load_run, parse_capture
    from ..engine.trainer import evaluate_all
    from ..utils import mesh_devices, resolve_device

    dev = resolve_device(args.device)
    devices = mesh_devices(dev) if args.mesh else None
    manifest, config, state = load_run(args.load_dir, dev)

    if args.data == "synthetic":
        from ..data.builder import dataset_from_scene
        from ..data.synthetic import SyntheticSceneConfig, render_scene

        data = dataset_from_scene(
            render_scene(SyntheticSceneConfig(num_cameras=24, image_size=128), device=dev), dev)
        n = data.cameras.num_cameras
        train_idx = data.train_indices.cpu().numpy()
        eval_idx = np.setdiff1d(np.arange(n), train_idx)
        eval_idx = eval_idx if len(eval_idx) else np.array([0])
    else:
        from ..data.builder import dataset_from_parsed

        parsed = parse_capture(args.data, manifest)
        data = dataset_from_parsed(parsed, dev)
        eval_idx, train_idx = parsed.eval_indices, parsed.train_indices

    indices = {
        "eval": eval_idx,
        "train": train_idx,
        "all": np.arange(data.cameras.num_cameras),
    }[args.split]
    stats = evaluate_all(state.params, data, indices, config,
                         lpips_weights_path=args.lpips_weights, devices=devices)
    stats["num_images_evaluated"] = len(indices)
    stats["step"] = state.step
    stats["device"] = str(dev)
    print(json.dumps(stats, indent=2))
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(stats, indent=2))
    return stats
