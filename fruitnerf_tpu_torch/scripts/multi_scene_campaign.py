"""Multi-scene counting campaign: train S orchards in ONE batched step (the
scene axis vmapped over the train step, split into one scene group a card
when there are at least as many cards as scenes), then export and count
each scene. Twin of ``fruitnerf_tpu/scripts/multi_scene_campaign.py``.

The reference evaluates 12 synthetic + 16 real scenes as a fleet of
independent runs (clustering/config_synthetic.py, config_real.py;
run_clustering.py:94-130). Here every scene's field trains in one step
(``parallel/multi_scene.py``: each grid kernel launches once for all
scenes), then each is volume-exported and counted against its own GT
centres.

    python -m fruitnerf_tpu_torch multi-scene --scenes 4 --num-fruits 8 \\
        --num-cameras 80 --image-size 128 --iters 4000 --output-dir runs/camp

It runs on the card unless ``--device cpu`` asks for the CPU. The twin's
chunked dispatch (``lax.scan``) is not ported; a chunk equals its steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--num-fruits", type=int, default=8,
                   help="fruits in scene 0; scene s has num_fruits + "
                        "s*fruit-step more")
    p.add_argument("--fruit-step", type=int, default=1,
                   help="fruit-count increment between scenes (spread "
                        "campaign scenes over a density range)")
    p.add_argument("--num-cameras", type=int, default=80)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--fruit-radius", type=float, default=None,
                   help="override the orchard fruit radius (the CPU-mesh CI "
                        "campaign uses chunky fruits at low resolution so "
                        "short smoke-preset runs reach countable exports)")
    p.add_argument("--preset", default="fruit_nerf")
    p.add_argument("--variant", default="grid",
                   choices=["grid", "tpu", "parity"])
    p.add_argument("--sparsity-loss", type=float, default=0.005)
    p.add_argument("--density-bias", type=float, default=None,
                   help="override the density-logit init bias (production "
                        "presets default to -3 = empty-start, the round-3 "
                        "headline recipe together with the sparsity prior)")
    p.add_argument("--export-n", type=int, default=192)
    p.add_argument("--train-rays-per-batch", type=int, default=2048)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--seed", type=int, default=11)
    # export thresholds: reference run-scale defaults (exporter_utils.py:
    # 110-114) assume 30k-step logit/density magnitudes; short campaign
    # runs (4-8k iters) may need lower cutoffs (tests/test_disk_e2e.py)
    p.add_argument("--density-threshold", type=float, default=70.0)
    p.add_argument("--semantic-logit-threshold", type=float, default=3.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def campaign_config(args, num_images: int):
    """The campaign's train config: the preset with the campaign's steps,
    rays, sparsity prior and density bias."""
    from ..configs import run_preset

    config = run_preset(args.preset, num_images, args.variant)
    config = dataclasses.replace(
        config, max_iters=args.iters, train_rays_per_batch=args.train_rays_per_batch)
    model = config.model
    if args.sparsity_loss > 0:
        model = dataclasses.replace(model, density_sparsity_mult=args.sparsity_loss)
    if args.density_bias is not None:
        model = dataclasses.replace(
            model, field=dataclasses.replace(model.field, density_bias=args.density_bias))
    return dataclasses.replace(config, model=model)


def scene_configs(args) -> list:
    """S structurally identical orchards with spread fruit counts."""
    from ..data.synthetic import orchard_config

    out = []
    for s in range(args.scenes):
        cfg = orchard_config(
            num_fruits=args.num_fruits + s * args.fruit_step,
            num_cameras=args.num_cameras,
            image_size=args.image_size, seed=args.seed + 101 * s,
        )
        if args.fruit_radius is not None:
            cfg = dataclasses.replace(
                cfg, fruit_radius=args.fruit_radius, leaf_radius=args.fruit_radius * 1.3)
        out.append(cfg)
    return out


def main(args):
    import torch

    from ..bridge import index_tree
    from ..counting.clustering import FruitClustering, evaluate_against_gt
    from ..data.builder import dataset_from_scene
    from ..data.synthetic import render_scene
    from ..export.volume_sampler import ExportConfig, sample_volume
    from ..parallel.multi_scene import init_multi_scene_state, multi_scene_step, stack_datasets
    from ..utils import mesh_devices, resolve_device
    from .orchard_e2e import counting_profile_for

    dev = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    report: dict = {"args": vars(args),
                    "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    # ---- render S structurally identical orchards (varying fruit counts) --
    t0 = time.time()
    scenes = [(cfg, render_scene(cfg, device=dev)) for cfg in scene_configs(args)]
    datasets = [dataset_from_scene(sc, dev, train_fraction=1.0) for _, sc in scenes]
    datas = stack_datasets(datasets)
    report["render_s"] = round(time.time() - t0, 1)

    n_cams = datasets[0].cameras.num_cameras
    config = campaign_config(args, n_cams)

    # ---- one batched step trains every scene ------------------------------
    # a scene group a card where there is a card a scene (the twin's rule);
    # otherwise one card runs every scene batched, no collectives
    cards = mesh_devices(dev)
    devices = cards[: args.scenes] if len(cards) >= args.scenes > 1 else None
    state, generators = init_multi_scene_state(config, n_cams, args.scenes, dev)

    t0 = time.time()
    for _ in range(args.iters):
        metrics = multi_scene_step(state, datas, config, generators, devices=devices)
    losses = metrics["total_loss"].double().cpu().numpy()  # waits for the steps
    train_s = time.time() - t0
    report["train_s"] = round(train_s, 1)
    report["train_rays_per_sec_all_scenes"] = round(
        args.iters * args.train_rays_per_batch * args.scenes / train_s
    )
    report["final_loss_per_scene"] = [round(float(x), 4) for x in losses]
    report["final_psnr_per_scene"] = [round(float(x), 2) for x in metrics["psnr"].tolist()]

    # ---- per-scene export + count -----------------------------------------
    export_cfg = ExportConfig(
        num_points_per_side=args.export_n,
        density_threshold=args.density_threshold,
        semantic_logit_threshold=args.semantic_logit_threshold,
    )
    rows = []
    for s, (cfg_scene, scene) in enumerate(scenes):
        clouds = sample_volume(
            index_tree(state.params["model"], s), config.model, export_cfg,
            dataparser_scale=1.0, output_dir=out / f"scene_{s:02d}", progress=False,
        )
        gt_count = args.num_fruits + s * args.fruit_step
        profile = counting_profile_for(cfg_scene.fruit_radius, gt_count)
        # count the path-of-record colormap cloud (sigmoid>=0.9 & density —
        # a superset of the logit>=3 semantic cloud, see volume_sampler);
        # fall back to semantic if a scene's colormap came out empty
        pts = clouds["semantic_colormap"]["points"]
        if len(pts) == 0:
            pts = clouds["semantic"]["points"]
        if len(pts) == 0:
            rows.append({"scene": s, "gt": gt_count, "count": 0,
                         "error": "empty cloud"})
            continue
        result = FruitClustering(profile, device=dev).count(pts)
        gt = evaluate_against_gt(
            result.centers, scene["fruit_centers"],
            tolerance=max(0.15, 5.0 * cfg_scene.fruit_radius),
        )
        rows.append({
            "scene": s, "gt": gt_count, "count": result.count,
            "F1": round(float(gt["F1"]), 4),
            "cloud_points": int(len(pts)),
        })
    report["scenes"] = rows
    report["scenes_exact"] = sum(1 for r in rows if r.get("count") == r["gt"])
    report["scenes_within_1"] = sum(
        1 for r in rows if abs(r.get("count", 0) - r["gt"]) <= 1
    )

    with open(out / "campaign_report.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
