"""Export CLI: the semantic point clouds of a trained run, or its RGB
point cloud. Twin of ``fruitnerf_tpu/scripts/export.py``.

    python -m fruitnerf_tpu_torch export --load-dir runs/my_run --output-dir out/ \\
        --num-points-per-side 1000
    python -m fruitnerf_tpu_torch export --load-dir runs/my_run --output-dir out/ \\
        --mode pointcloud --data <capture dir>|synthetic

The run's manifest rebuilds the training config (preset, variant, config
overrides) and its field's encoding and layout, which must match; the
latest checkpoint supplies the parameters. ``--mode semantic-pointcloud``
writes ``semantic.ply``, ``semantic_colormap.ply`` and ``density.ply``;
``--mode pointcloud`` renders cameras, back-projects their depth and
writes ``point_cloud.ply`` (``export/rgb_pointcloud.py``), parsing a
capture at the run's split and downscale factor. It runs on the card
unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--load-dir", required=True, help="run dir (manifest + checkpoints)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mode", choices=("semantic-pointcloud", "pointcloud"),
                   default="semantic-pointcloud",
                   help="semantic volume export, or the stock depth-"
                        "backprojected RGB cloud (exporter.py:124-129)")
    p.add_argument("--data", default="synthetic",
                   help="pointcloud mode: dataset dir with transforms.json, "
                        "or 'synthetic'")
    p.add_argument("--num-points", type=int, default=1_000_000,
                   help="pointcloud mode: target cloud size")
    p.add_argument("--acc-threshold", type=float, default=0.5)
    p.add_argument("--pointcloud-cameras", type=int, default=24,
                   help="pointcloud mode: number of cameras to render")
    p.add_argument("--num-points-per-side", type=int, default=1000)
    p.add_argument("--num-rays-per-batch", type=int, default=32768)
    p.add_argument("--bounding-box-min", type=float, nargs=3, default=(-1, -1, -1))
    p.add_argument("--bounding-box-max", type=float, nargs=3, default=(1, 1, 1))
    p.add_argument("--semantic-logit-threshold", type=float, default=3.0)
    p.add_argument("--density-threshold", type=float, default=70.0)
    p.add_argument(
        "--colormap-prob-threshold", type=float, default=0.9,
        help="sigmoid threshold for the semantic_colormap cloud; 0.9 is the "
             "reference's EFFECTIVE mask (its >=0.999 compare runs on the "
             "binary heaviside@0.9 label, fruit_nerf.py:261-265 + "
             "exporter_utils.py:106,112 — see export/volume_sampler.py)",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="shard the probe stream over all visible cards (each card "
             "field-queries and masks its ray shard of every batch)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def main(args):
    from ..engine.runs import load_run
    from ..export.volume_sampler import ExportConfig, sample_volume
    from ..utils import mesh_devices, resolve_device

    dev = resolve_device(args.device)
    manifest, config, state = load_run(args.load_dir, dev)
    if args.mode == "pointcloud":
        return _rgb_pointcloud(args, manifest, config, state, dev)

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
        devices=mesh_devices(dev) if args.mesh else None,
    )
    for name, d in out.items():
        print(f"{name}: {d['points'].shape[0]} points -> {d['path']}")
    return out


def _rgb_pointcloud(args, manifest, config, state, dev):
    """``--mode pointcloud``: the depth-backprojected RGB cloud of the first
    ``--pointcloud-cameras`` cameras, written as ``point_cloud.ply``. A
    capture is parsed at the run's split and downscale factor (the JAX twin
    parses at the automatic factor, another resolution for a run trained at
    a forced one)."""
    from pathlib import Path

    from ..export.ply import write_ply
    from ..export.rgb_pointcloud import export_rgb_pointcloud

    if args.data == "synthetic":
        from ..data.builder import cameras_from_scene
        from ..data.synthetic import SyntheticSceneConfig, render_scene

        cameras = cameras_from_scene(render_scene(SyntheticSceneConfig(
            num_cameras=args.pointcloud_cameras, image_size=256), device=dev), dev)
    else:
        from ..data.builder import cameras_from_parsed
        from ..engine.runs import parse_capture

        cameras = cameras_from_parsed(parse_capture(args.data, manifest), dev)
    indices = list(range(min(args.pointcloud_cameras, cameras.num_cameras)))
    pts, cols = export_rgb_pointcloud(
        state.params, config, cameras, indices,
        num_points=args.num_points, acc_threshold=args.acc_threshold,
        dataparser_scale=manifest["dataparser_scale"],
    )
    path = write_ply(Path(args.output_dir) / "point_cloud.ply", pts, cols)
    print(f"point_cloud: {len(pts)} points -> {path}")
    return {"points": pts, "colors": cols, "path": path}
