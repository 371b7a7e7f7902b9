"""Training CLI — the ``ns-train fruit_nerf`` equivalent. Twin of
``fruitnerf_tpu/scripts/train.py``.

    python -m fruitnerf_tpu_torch train --preset fruit_nerf --data <dir> \\
        --output-dir runs/my_run

``--data`` is a capture directory (``transforms.json``, images, fruit
masks; ``data/dataparser.py``) or ``synthetic``, the built-in procedural
scene. The run directory receives ``manifest.json`` (what ``export``,
``eval`` and ``render`` read), ``checkpoints/`` and ``metrics.jsonl``. It
runs on the card unless ``--device cpu`` asks for the CPU.

The big and huge presets train on at most 200 of the train images
(``max_train_images``, evenly spaced); the manifest records how many were
kept (``num_train_images``). Unlike the twin, the manifest of a capture run
records the ``--downscale-factor`` it was trained at (null: the
dataparser's automatic rule), and ``eval`` and ``render`` parse the capture
again at it.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default="fruit_nerf",
                   help="fruit_nerf | fruit_nerf_big | fruit_nerf_huge | fruit_nerf_smoke")
    p.add_argument("--variant", default="grid",
                   choices=["grid", "tpu", "parity"])
    p.add_argument("--data", required=True,
                   help="dataset dir with transforms.json, or 'synthetic'")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--train-rays-per-batch", type=int, default=None)
    p.add_argument("--downscale-factor", type=int, default=None)
    p.add_argument("--train-split-fraction", type=float, default=None,
                   help="override the preset's train split fraction")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in output-dir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lpips-weights", default=None,
                   help="npz of LPIPS backbone weights (utils/lpips.py schema); "
                        "adds LPIPS to eval metrics")
    p.add_argument("--sparsity-loss", type=float, default=0.0,
                   help="occupancy-sparsity weight; recommended ~0.005 on "
                        "bright-background captures to suppress background-"
                        "colored fog (0 = off, reference parity)")
    p.add_argument("--distortion-loss", action="store_true",
                   help="add the distortion term to the loss (the reference "
                        "keeps it metric-only, fruit_nerf.py:400)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def main(args):
    import torch

    from ..configs import apply_overrides, run_preset
    from ..engine.checkpoints import resume_from_latest, write_manifest
    from ..engine.trainer import (
        evaluate_all,
        init_train_state,
        subsample_train_images,
        train_loop,
    )
    from ..utils import resolve_device
    from ..utils.writer import MetricWriter

    dev = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # the preset's split fraction must reach the dataparser; num_images does
    # not affect it, so probe with 1
    split = (run_preset(args.preset, 1, args.variant).train_split_fraction
             if args.train_split_fraction is None else args.train_split_fraction)
    if args.data == "synthetic":
        from ..data.builder import dataset_from_scene
        from ..data.synthetic import SyntheticSceneConfig, render_scene

        scene = render_scene(SyntheticSceneConfig(num_cameras=24, image_size=128), device=dev)
        data = dataset_from_scene(scene, dev, train_fraction=split)
        eval_indices = np.array([0])
        frame = dict(dataparser_transform=np.eye(4)[:3], dataparser_scale=1.0,
                     scene_aabb=np.array([[-1.0] * 3, [1.0] * 3]))
        capture = {}
    else:
        from ..data.builder import dataset_from_parsed
        from ..data.dataparser import DataParserConfig, parse_transforms

        parsed = parse_transforms(DataParserConfig(
            data_dir=Path(args.data), downscale_factor=args.downscale_factor,
            train_split_fraction=split))
        data = dataset_from_parsed(parsed, dev)
        eval_indices = parsed.eval_indices
        frame = dict(dataparser_transform=parsed.dataparser_transform,
                     dataparser_scale=parsed.dataparser_scale, scene_aabb=parsed.scene_aabb,
                     semantics_classes=parsed.semantics_classes)
        capture = {"downscale_factor": args.downscale_factor}
    num_images = data.cameras.num_cameras
    config = run_preset(args.preset, num_images, args.variant)
    overrides = {
        k: v for k, v in {
            "train_rays_per_batch": args.train_rays_per_batch,
            "sparsity_loss": args.sparsity_loss or None,
            "distortion_loss": True if args.distortion_loss else None,
        }.items() if v is not None
    }
    config = apply_overrides(config, overrides)
    config = dataclasses.replace(
        config, seed=args.seed, max_iters=args.max_iters or config.max_iters
    )
    if config.max_train_images is not None:
        data = subsample_train_images(data, config.max_train_images)
    write_manifest(
        out_dir, preset=config.preset, num_images=num_images,
        grid=config.model.field.encoding_config, **frame,
        extra={"variant": args.variant, "max_iters": config.max_iters,
               "train_split_fraction": split, "config_overrides": overrides,
               "num_train_images": len(data.train_indices), **capture},
    )

    gen = torch.Generator(device=dev).manual_seed(config.seed)
    state = None
    ckpt_dir = out_dir / "checkpoints"
    if args.resume:  # a restore sets the generator's state too
        restored, resumed = resume_from_latest(
            ckpt_dir, init_train_state(config, num_images, dev), gen
        )
        print(f"resume: {f'from step {restored.step}' if resumed else 'no checkpoint found'}")
        state = restored if resumed else None
    writer = MetricWriter(out_dir / "metrics.jsonl")
    timings: dict = {}
    state = train_loop(config, data, eval_indices=eval_indices, state=state, generator=gen,
                       writer=writer, checkpoint_dir=ckpt_dir, timings=timings)
    if len(eval_indices):
        # full-eval-set averages, the get_average_eval_image_metrics analog
        # (fruit_pipeline.py:176-227)
        stats = evaluate_all(state.params, data, eval_indices, config,
                             lpips_weights_path=args.lpips_weights)
        writer.write(state.step, {f"final_eval_{k}": v for k, v in stats.items()})
    writer.close()
    print(f"done: step {state.step}, artifacts in {out_dir}")
    return state, timings
