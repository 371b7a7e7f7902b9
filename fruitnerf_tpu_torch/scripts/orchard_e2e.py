"""Reference-scale end-to-end run: synthetic orchard -> train -> volume
export -> counting cascade -> ground-truth metrics. Twin of
``fruitnerf_tpu/scripts/orchard_e2e.py``; writes ``orchard_report.json``
with its keys.

    python -m fruitnerf_tpu_torch orchard-e2e --num-fruits 120 --num-cameras 200 \\
        --image-size 256 --iters 30000 --export-n 384 --output-dir runs/bench

It runs on the card unless ``--device cpu`` asks for the CPU, and raises
where there is no card; the report's ``device`` names the card, or "cpu".
A rerun on the same ``--output-dir`` resumes from the latest checkpoint.
Unlike the JAX twin it writes the manifest before training, with the
scene's camera elevation, and a resume whose ``--camera-elevation`` differs
from the manifest's raises ValueError. A run of zero steps (a resume at the final step) reports its
rates as null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--num-fruits", type=int, default=283)
    p.add_argument("--num-cameras", type=int, default=120)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--variant", default="grid",
                   choices=["grid", "tpu", "parity"])
    p.add_argument("--preset", default="fruit_nerf")
    p.add_argument("--export-n", type=int, default=512,
                   help="probe-grid side length N (N^3 probes)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--train-rays-per-batch", type=int, default=None)
    p.add_argument("--distortion-loss", action="store_true",
                   help="add the distortion term to the loss (anti-floater; "
                        "the reference keeps it metric-only, "
                        "fruit_nerf.py:400)")
    p.add_argument("--sparsity-loss", type=float, default=0.005,
                   help="occupancy-sparsity weight; the headline counting "
                        "recipe is preset density-bias -3 + prior 0.005 "
                        "(carves inter-fruit bridges the cascade would "
                        "otherwise over-split, NOTES_ROUND3); 0 = off")
    p.add_argument("--table-size", type=int, default=None,
                   help="override the grid variant's per-level table size")
    p.add_argument("--mid-table-size", type=int, default=None,
                   help="two-tier capacity: cap all but the finest "
                        "--fine-levels levels at this table size (kernel "
                        "cost is linear in sum(T_l); see "
                        "GridEncodingConfig.mid_table_size)")
    p.add_argument("--fine-levels", type=int, default=None,
                   help="how many finest levels keep the full table size "
                        "when --mid-table-size is set (default 4)")
    p.add_argument("--grid-levels", type=int, default=None,
                   help="override the grid variant's number of levels "
                        "(same base/max res; the encode cost is linear in "
                        "hashed levels, so L is a speed-vs-quality axis)")
    p.add_argument("--nerf-samples", type=int, default=None,
                   help="override num_nerf_samples (field samples/ray; the "
                        "48->32 speed/quality trade study)")
    p.add_argument("--sparsity-boost", type=float, default=None,
                   help="override sparsity_unobserved_boost (frustum-gap fog)")
    p.add_argument("--sparsity-points", type=int, default=None,
                   help="override sparsity_num_points")
    p.add_argument("--sparsity-cell", type=float, default=None,
                   help="override sparsity_cell (occupancy cell size)")
    p.add_argument("--density-bias", type=float, default=None,
                   help="override the density-logit init bias (production "
                        "presets default to -3 = empty-start; 0 restores "
                        "the reference-equivalent fog init)")
    p.add_argument("--no-camera-opt", action="store_true",
                   help="disable the SO3xR3 camera optimizer (synthetic "
                        "scenes have exact poses; with a negative density "
                        "bias, early pose gradients can run poses away "
                        "before geometry forms)")
    p.add_argument("--no-jitter", action="store_true",
                   help="disable sub-pixel ray jitter (A/B isolation)")
    p.add_argument("--camera-elevation", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="camera elevation sweep in radians (default keeps the "
                        "historic (0.25, 0.80) upper ring; ~(-0.2, 0.8) adds "
                        "below-horizon views of the low crown, mirroring the "
                        "reference's capture protocol of circling the tree "
                        "at fruit height)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def cli_overrides(args) -> dict:
    """Flat config-override dict (configs.OVERRIDE_KEYS) from CLI args.

    Only keys the user actually set are returned (None = not requested), so
    the manifest's ``config_overrides`` records exactly the deltas needed to
    rebuild this run's config at export/eval/viewer time — the equivalent of
    the reference persisting its full config.yaml per run (exporter.py:86).
    ``--sparsity-loss`` is always recorded (it is a float flag with a non-zero
    default that IS the headline recipe), including an explicit 0
    (ADVICE r4: truthiness checks dropped explicit zeros).
    """
    return {
        k: v
        for k, v in {
            "train_rays_per_batch": args.train_rays_per_batch,
            "distortion_loss": True if args.distortion_loss else None,
            "sparsity_loss": args.sparsity_loss,
            "sparsity_boost": args.sparsity_boost,
            "sparsity_points": args.sparsity_points,
            "sparsity_cell": args.sparsity_cell,
            "table_size": args.table_size,
            "grid_levels": args.grid_levels,
            "mid_table_size": args.mid_table_size,
            "fine_levels": args.fine_levels,
            "nerf_samples": args.nerf_samples,
            "density_bias": args.density_bias,
            "camera_opt": False if args.no_camera_opt else None,
            "subpixel_jitter": False if args.no_jitter else None,
        }.items()
        if v is not None
    }


def counting_profile_for(fruit_radius_world: float, num_fruits: int):
    """Counting profile scaled to the orchard's fruit radius, in TRUE world
    units: exported clouds land in x1 world coordinates (the 1/scale x2
    un-normalization cancels the contraction/normalization mismatch —
    round-1 calibration finding, re-verified here: 99.8% of exported
    semantic points fall within 2 fruit radii of a true center at x1, none
    at x2). Density hyperparameters are calibrated for threshold-crossing
    clouds (~175 pts/fruit at 512^3): light outlier removal, small
    min_samples, prune factor sized for partial hulls. Round-3 headline
    (283 fruits / 300 cams / 512^2, bias -3 + prior 5e-3, jitter on):
    count 284/283 (0.35%), F1 0.970; prior-only gives 287 (1.4%), and
    NO-prior clouds over-split to ~300 (bridged blobs, NOTES_ROUND3)."""
    from ..counting.clustering import CountingProfile
    from ..counting.templates import BASE_RADIUS

    r = fruit_radius_world
    return CountingProfile(
        name=f"orchard_{num_fruits}",
        # The synthetic orchard renders SPHERE fruits; the template must match
        # the scene's fruit shape (as the reference pairs apple_template.ply
        # with the apple scene, run_clustering.py:40-47). Round-4 used the
        # apple template here, whose hull is ~0.45x a sphere's — every
        # near-complete single-fruit shell then exceeded the reference's
        # vol > template/0.9 split gate and the split stage over-cut
        # (VERDICT r4 weak #2: +20 FP at the best recipe).
        template="sphere",
        template_size=r / BASE_RADIUS,
        remove_outliers_nb_points=3,
        remove_outliers_radius=0.45 * r,
        down_sample=0.03 * r,
        eps=0.6 * r,
        min_samples=6,
        cluster_merge_distance=1.2 * r,
        # Round-5 full-cascade calibration (scripts_dev/simulate_cascade.py:
        # simulate split+prune on the three committed round-4 clouds, score
        # FINAL count + GT-matched F1): gate 1.6 — a complete single-fruit
        # shell's hull is ~1 sphere volume and the threshold band fattens it,
        # so the reference's 1/0.9 gate sends nearly every whole fruit into
        # the split branch; penalty 0.2r stops the flat-tail Ward argmin
        # drifting to k>1 on single fruits (r4 weak #2: +20 FP); prune 0.005
        # — 0.02 was pruning real partial shells (9 of 15 pruned on the r4
        # default-headline cloud had a true fruit). Result on the committed
        # clouds: mid4096f4 284/283 (0.35%, F1 0.970), default 279/283
        # (1.41%, F1 0.986), plum 625/781 (field-limited: 162 fruits have
        # zero export points at N=512 — NOTES_ROUND5).
        minimum_size_factor=0.005,
        split_volume_gate=1.6,
        split_k_penalty=0.2 * r,
        gt_count=num_fruits,
    )


def _rate(steps: int, rays_per_step: int, seconds: float | None):
    return steps * rays_per_step / seconds if steps > 0 and seconds else None


def main(args, adjust=None):
    """Run the orchard end to end; returns the report. ``adjust`` (a
    function of the TrainConfig, default none) changes the config after the
    CLI's overrides: ``scripts/convergence.py`` sets the train seed and the
    learning-rate horizon with it."""
    import torch

    from ..configs import apply_overrides, run_preset
    from ..counting.clustering import FruitClustering, evaluate_against_gt
    from ..data.builder import dataset_from_scene
    from ..data.synthetic import cached_render_scene, orchard_config
    from ..engine import checkpoints as ck
    from ..engine.trainer import evaluate_all, init_train_state, train_loop
    from ..export.volume_sampler import ExportConfig, sample_volume
    from ..utils import resolve_device
    from ..utils.writer import MetricWriter

    dev = resolve_device(args.device)
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

    config = run_preset(args.preset, n, args.variant)
    config = dataclasses.replace(config, max_iters=args.iters)
    overrides = cli_overrides(args)
    config = apply_overrides(config, overrides)
    if adjust is not None:
        config = adjust(config)
    grid = config.model.field.encoding_config
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
        ck.table_from_manifest(manifest, config.model.field)
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
        result = FruitClustering(profile, device=dev).count(pts)
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
