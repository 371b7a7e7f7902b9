"""Export CLI: the semantic point clouds of a trained run. Twin of
``fruitnerf_tpu/scripts/export.py`` (``--mode semantic-pointcloud``).

    python -m fruitnerf_tpu_torch export --load-dir runs/my_run --output-dir out/ \\
        --num-points-per-side 1000

The run's manifest rebuilds the training config (preset, variant, config
overrides) and its grid layout, which must match; the latest checkpoint
supplies the parameters. Writes ``semantic.ply``, ``semantic_colormap.ply``
and ``density.ply`` into ``--output-dir``.
"""
from __future__ import annotations

from pathlib import Path

from fruitnerf_tpu.scripts.export import add_args  # noqa: F401  (the CLI is shared)


def main(args):
    import torch

    from ..configs import apply_overrides, get_preset
    from ..engine.checkpoints import grid_from_manifest, read_manifest, resume_from_latest
    from ..engine.trainer import init_train_state
    from ..export.volume_sampler import ExportConfig, sample_volume

    if args.mode == "pointcloud":
        raise NotImplementedError(
            "export --mode pointcloud (the depth-backprojected RGB cloud) is not ported "
            "(ROADMAP Queue 1 item 14)"
        )
    if args.mesh:
        raise NotImplementedError(
            "export --mesh (multi-device export) is not ported (ROADMAP Queue 1 item 13)"
        )
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    run_dir = Path(args.load_dir)
    manifest = read_manifest(run_dir)
    preset, num_images = manifest["preset"], manifest["num_images"]
    variant = manifest.get("variant", "tpu")
    config = get_preset(preset, num_images=num_images, variant=variant)
    config = apply_overrides(config, manifest.get("config_overrides", {}))
    grid_from_manifest(manifest, expect=config.model.field.grid)

    state, resumed = resume_from_latest(
        run_dir / "checkpoints", init_train_state(config, num_images, dev)
    )
    if not resumed:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/checkpoints")
    print(f"loaded step {state.step} ({preset}, variant={variant}) on {dev}")

    export_config = ExportConfig(
        bounding_box_min=tuple(args.bounding_box_min),
        bounding_box_max=tuple(args.bounding_box_max),
        num_points_per_side=args.num_points_per_side,
        num_rays_per_batch=args.num_rays_per_batch,
        semantic_logit_threshold=args.semantic_logit_threshold,
        density_threshold=args.density_threshold,
        colormap_prob_threshold=args.colormap_prob_threshold,
    )
    out = sample_volume(
        state.params["model"], config.model, export_config,
        dataparser_scale=manifest["dataparser_scale"], output_dir=args.output_dir,
    )
    for name, d in out.items():
        print(f"{name}: {d['points'].shape[0]} points -> {d['path']}")
    return out
