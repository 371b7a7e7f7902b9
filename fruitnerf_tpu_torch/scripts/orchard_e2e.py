"""Reference-scale end-to-end run: synthetic orchard -> train -> volume
export -> counting cascade -> ground-truth metrics. Twin of
``fruitnerf_tpu/scripts/orchard_e2e.py``; writes ``orchard_report.json``
with its keys.

    python -m fruitnerf_tpu_torch orchard-e2e --num-fruits 120 --num-cameras 200 \\
        --image-size 256 --iters 30000 --export-n 384 --output-dir runs/bench

It runs on the GPU when there is one, else on the CPU; the report's
``device`` names the card, or "cpu". A rerun on the same
``--output-dir`` resumes from the latest checkpoint. Unlike the JAX twin it
writes the manifest before training, with the scene's camera elevation, and
a resume whose ``--camera-elevation`` differs from the manifest's raises
ValueError. A run of zero steps (a resume at the final step) reports its
rates as null.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from fruitnerf_tpu.scripts.orchard_e2e import (  # noqa: F401  (the CLI and profile are shared)
    add_args,
    cli_overrides,
    counting_profile_for,
)


def _rate(steps: int, rays_per_step: int, seconds: float | None):
    return steps * rays_per_step / seconds if steps > 0 and seconds else None


def main(args):
    import torch

    from fruitnerf_tpu.counting.clustering import FruitClustering, evaluate_against_gt

    from ..configs import apply_overrides, get_preset
    from ..data.builder import dataset_from_scene
    from ..data.synthetic import cached_render_scene, orchard_config
    from ..engine import checkpoints as ck
    from ..engine.trainer import evaluate_all, init_train_state, train_loop
    from ..export.volume_sampler import ExportConfig, sample_volume
    from ..utils.writer import MetricWriter

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    # the device the numbers below were taken on: the card's name, or "cpu"
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report: dict = {"args": vars(args), "device": device}

    t0 = time.perf_counter()
    cfg_scene = orchard_config(
        num_fruits=args.num_fruits, num_cameras=args.num_cameras,
        image_size=args.image_size, seed=args.seed,
        camera_elevation=args.camera_elevation,
    )
    scene = cached_render_scene(cfg_scene, device=dev)
    report["render_scene_s"] = time.perf_counter() - t0
    report["fruit_radius"] = cfg_scene.fruit_radius

    data = dataset_from_scene(scene, dev, train_fraction=0.95)
    n = data.cameras.num_cameras
    train_set = set(data.train_indices.tolist())
    eval_idx = np.asarray([i for i in range(n) if i not in train_set] or [0])

    config = get_preset(args.preset, num_images=n, variant=args.variant)
    config = dataclasses.replace(config, max_iters=args.iters)
    overrides = cli_overrides(args)
    config = apply_overrides(config, overrides)
    grid = config.model.field.grid
    elevation = [float(e) for e in cfg_scene.camera_elevation]

    ckpt_dir = out / "checkpoints"
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    state = None
    if ck.latest_checkpoint(ckpt_dir) is not None:  # preemption recovery
        manifest = ck.read_manifest(out)
        if manifest.get("camera_elevation") != elevation:
            raise ValueError(
                f"resume of {out}: --camera-elevation gives {elevation}, the run was "
                f"trained on {manifest.get('camera_elevation')}"
            )
        ck.grid_from_manifest(manifest, expect=grid)
        state, _ = ck.resume_from_latest(ckpt_dir, init_train_state(config, n, dev), gen)
        print(f"resuming from step {state.step}", flush=True)
    else:
        ck.write_manifest(
            out, preset=args.preset, dataparser_transform=np.eye(4)[:3],
            dataparser_scale=1.0, scene_aabb=np.array([[-1.0] * 3, [1.0] * 3]),
            num_images=n, grid=grid,
            extra={"variant": args.variant, "config_overrides": overrides,
                   "camera_elevation": elevation},
        )
    start_step = state.step if state is not None else 0

    t0 = time.perf_counter()
    writer = MetricWriter(out / "metrics.jsonl")
    timings: dict = {}
    state = train_loop(config, data, eval_indices=eval_idx, state=state, generator=gen,
                       writer=writer, checkpoint_dir=ckpt_dir, timings=timings)
    writer.close()
    train_s = time.perf_counter() - t0
    # only the steps this process ran: a resume starts late, SIGTERM ends early
    steps_run = state.step - start_step
    rays = config.train_rays_per_batch
    report["train_s"] = train_s
    report["train_rays_per_sec"] = _rate(steps_run, rays, train_s)
    report["loop_timings"] = dict(timings)
    report["train_rays_per_sec_train_only"] = _rate(steps_run, rays, timings.get("train_s"))
    report["steps_run"] = steps_run
    if start_step:
        report["resumed_from_step"] = start_step

    if state.step < args.iters:
        # preempted: record it and leave the last full report alone; a rerun resumes
        report["preempted_at_step"] = state.step
        with open(out / "orchard_report_preempted.json", "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(report, indent=2))
        return report

    t0 = time.perf_counter()
    report["eval"] = evaluate_all(state.params, data, eval_idx, config)
    report["eval_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    clouds = sample_volume(
        state.params["model"], config.model, ExportConfig(num_points_per_side=args.export_n),
        dataparser_scale=1.0, output_dir=out, progress=False,
    )
    export_s = time.perf_counter() - t0
    report["export_s"] = export_s
    report["export_probes_per_sec"] = args.export_n**3 / export_s
    report["export_points"] = {k: int(len(v["points"])) for k, v in clouds.items()}

    profile = counting_profile_for(cfg_scene.fruit_radius, args.num_fruits)
    t0 = time.perf_counter()
    counting = {}
    for cloud_name in ("semantic_colormap", "semantic"):
        pts = clouds[cloud_name]["points"]
        if len(pts) == 0:
            counting[cloud_name] = {"count": 0, "error": "empty cloud"}
            continue
        result = FruitClustering(profile).count(pts)
        # the match tolerance scales with the fruit (the reference's 0.15
        # for ~0.03-radius apples is about 5 radii)
        gt = evaluate_against_gt(
            result.centers, scene["fruit_centers"],
            tolerance=max(0.15, 5.0 * cfg_scene.fruit_radius),
        )
        counting[cloud_name] = {
            "count": result.count,
            "first_stage": result.first_stage,
            "fused": result.fused,
            "additional": result.additional,
            "pruned": result.pruned,
            "count_error_pct": 100.0 * abs(result.count - args.num_fruits) / args.num_fruits,
            **{k: float(v) if isinstance(v, float) else v for k, v in gt.items()},
        }
    report["count_s"] = time.perf_counter() - t0
    report["counting"] = counting
    report["gt_count"] = args.num_fruits

    with open(out / "orchard_report.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
