"""Crop-box discovery — the offline equivalent of the reference's viewer
workflow (README.md:216: open the nerfstudio viewer, drag a crop box around
the tree, copy the bounds into ``ns-export-semantics``; viewer served by
debug/viewer.py:86-112). Twin of ``fruitnerf_tpu/scripts/suggest_crop.py``.

Probes the trained field on a coarse grid, finds the AABB of
semantic/density-occupied cells, and writes axis-aligned projection images
so the suggestion can be verified visually without any interactive viewer:

    python -m fruitnerf_tpu_torch suggest-crop --load-dir runs/my_run
    -> prints ready-to-paste --bounding-box-min/max flags
    -> writes crop_{xy,xz,yz}.png and crop_suggestion.json

The run restores through ``engine/runs.py:load_run``, which applies the
manifest's config overrides (the JAX twin does not, so a run trained with
a shape-changing override cannot be restored there). It runs on the card
unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--load-dir", required=True,
                   help="run dir (manifest + checkpoints)")
    p.add_argument("--output-dir", default=None,
                   help="where to write projections (default: load-dir)")
    p.add_argument("--grid", type=int, default=128,
                   help="probe grid side length")
    p.add_argument("--density-threshold", type=float, default=70.0)
    p.add_argument("--semantic-logit-threshold", type=float, default=3.0)
    p.add_argument("--pad-cells", type=int, default=2,
                   help="padding around the occupied AABB, in cells")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def occupancy_grids(params, model_config, n, density_thr, logit_thr,
                    rays_per_batch=16384):
    """[n,n,n] bool occupancy (density) and (semantic & density) grids over
    the +-1 scene box, probed with the export-mode forward on the device of
    ``params`` (the model's parameters); one grid-encoding launch a batch
    of ``rays_per_batch`` rays."""
    from ..core.rays import RayBundle
    from ..models.fruit_model import forward_export

    dev = params["field"]["base_mlp"]["w0"].device
    lin = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    xs, ys = np.meshgrid(lin, lin, indexing="ij")
    origins = torch.as_tensor(np.stack(
        [xs.ravel(), ys.ravel(), np.full(n * n, -1.0)], axis=-1
    ).astype(np.float32), device=dev)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev)
    direction = torch.tensor([0.0, 0.0, 1.0], device=dev)
    dens = torch.zeros((n * n, n), dtype=torch.bool, device=dev)
    sem = torch.zeros((n * n, n), dtype=torch.bool, device=dev)
    with torch.inference_mode():
        for s in range(0, n * n, rays_per_batch):
            chunk = origins[s : s + rays_per_batch]
            r = chunk.shape[0]
            bundle = RayBundle(
                origins=chunk,
                directions=direction.expand(r, 3),
                nears=torch.zeros((r,), device=dev),
                fars=torch.full((r,), 2.0, device=dev),
                camera_indices=torch.zeros((r,), dtype=torch.int64, device=dev),
            )
            out = forward_export(params, bundle, model_config, n, aabb)
            d = out["density"] >= density_thr
            dens[s : s + r] = d
            sem[s : s + r] = (out["semantics"] >= logit_thr) & d
    # rays run along +z from the z=-1 face: index [x, y, z-sample]
    return dens.reshape(n, n, n).cpu().numpy(), sem.reshape(n, n, n).cpu().numpy()


def occupied_aabb(occ: np.ndarray, pad_cells: int) -> np.ndarray | None:
    """[n,n,n] bool -> [2,3] AABB in [-1,1] coords, or None if empty."""
    n = occ.shape[0]
    idx = np.argwhere(occ)
    if len(idx) == 0:
        return None
    lo = np.maximum(idx.min(axis=0) - pad_cells, 0)
    hi = np.minimum(idx.max(axis=0) + 1 + pad_cells, n)
    return np.stack([lo / n * 2.0 - 1.0, hi / n * 2.0 - 1.0])


def _write_projections(occ_d, occ_s, out_dir: Path):
    """Max-projections along each axis; density gray, semantic red."""
    from PIL import Image

    written = []
    names = {0: "yz", 1: "xz", 2: "xy"}
    for axis, tag in names.items():
        d = occ_d.max(axis=axis).astype(np.float32)
        s = occ_s.max(axis=axis).astype(np.float32)
        img = np.stack([np.maximum(d * 0.5, s), d * 0.5, d * 0.5], axis=-1)
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        path = out_dir / f"crop_{tag}.png"
        Image.fromarray(np.flipud(img.swapaxes(0, 1))).resize(
            (512, 512), Image.NEAREST
        ).save(path)
        written.append(path)
    return written


def main(args):
    from ..engine.runs import load_run
    from ..utils import resolve_device

    dev = resolve_device(args.device)
    run_dir = Path(args.load_dir)
    out_dir = Path(args.output_dir or run_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    _, config, state = load_run(run_dir, dev)

    occ_d, occ_s = occupancy_grids(
        state.params["model"], config.model, args.grid,
        args.density_threshold, args.semantic_logit_threshold,
    )
    box_s = occupied_aabb(occ_s, args.pad_cells)
    box_d = occupied_aabb(occ_d, args.pad_cells)
    box = box_s if box_s is not None else box_d
    report = {
        "grid": args.grid,
        "density_cells": int(occ_d.sum()),
        "semantic_cells": int(occ_s.sum()),
        "density_aabb": None if box_d is None else box_d.round(4).tolist(),
        "semantic_aabb": None if box_s is None else box_s.round(4).tolist(),
    }
    images = _write_projections(occ_d, occ_s, out_dir)
    report["projections"] = [str(p) for p in images]
    with open(out_dir / "crop_suggestion.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if box is None:
        print("no occupied cells found — train longer or lower thresholds")
        return report
    lo, hi = box
    print(
        "suggested export flags:\n"
        f"  --bounding-box-min {lo[0]:.3f} {lo[1]:.3f} {lo[2]:.3f} "
        f"--bounding-box-max {hi[0]:.3f} {hi[1]:.3f} {hi[2]:.3f}"
    )
    return report


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    add_args(p)
    main(p.parse_args())
