"""Dataset preprocessing CLI — the ``ns-process-fruit-data fruit`` equivalent
(scripts/process_data.py:29-45 + fruit_nerf_dataset.py:256-378), mask
ingestion scope. Twin of ``fruitnerf_tpu/scripts/process_data.py`` (copied;
images through Pillow, as the twin):

    python -m fruitnerf_tpu_torch process-data --data <raw>/images \
        --data-semantic <raw>/masks --transforms <raw>/transforms.json \
        --output-dir <capture> [--camera-type equirectangular]

Per BASELINE.json, mask *generation* (Grounded-SAM / U-Net) is consumed as
precomputed input; this command ingests images + precomputed binary masks:
  * copies images/ and semantics/ into the output layout
  * writes downscaled images_{2,4,8}/ and semantics_{2,4,8}/ pyramids
    (num_downscales=3, fruit_nerf_dataset.py:288-300)
  * merges per-frame ``semantic_path`` + the semantics class list into an
    existing transforms.json (from COLMAP via e.g. ns-process-data), matching
    the reference's output contract (fruit_nerf_dataset.py:357-373)

COLMAP itself stays an external preprocessing step (it is a C++ binary the
reference also shells out to, fruit_nerf_dataset.py:343-345).
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np
from PIL import Image

SEMANTIC_CLASSES = ["apple", "stuff"]  # fruitnerf_dataparser.py:251


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--data", required=True, help="input images dir")
    p.add_argument("--data-semantic", required=True,
                   help="precomputed binary masks dir (matching filenames)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--transforms", default=None,
                   help="existing transforms.json with poses (e.g. from COLMAP); "
                        "if omitted, looks in --data's parent")
    p.add_argument("--num-downscales", type=int, default=3)
    p.add_argument("--camera-type", default="perspective",
                   choices=["perspective", "equirectangular"],
                   help="equirectangular: fan each 360 frame into planar views "
                        "before ingestion (fruit_nerf_dataset.py:277-283)")
    p.add_argument("--images-per-equirect", type=int, default=8, choices=[8, 14])


def _downscale(src: Path, dst: Path, factor: int, is_mask: bool):
    img = Image.open(src)
    w, h = img.size
    resample = Image.NEAREST if is_mask else Image.BILINEAR
    img.resize((max(w // factor, 1), max(h // factor, 1)), resample).save(dst)


def _expand_equirect(data_dir: Path, sem_dir: Path, out: Path, n_views: int):
    """Fan every equirectangular image (and its mask) into planar views; the
    resulting perspective folders replace the inputs for the rest of the
    pipeline. Poses must then come from COLMAP on the planar views, as in the
    reference (fruit_nerf_dataset.py:277-283)."""
    from ..data.equirect import generate_planar_projections

    pers_images = out / "_planar_images"
    pers_masks = out / "_planar_semantics"
    pers_images.mkdir(parents=True, exist_ok=True)
    pers_masks.mkdir(parents=True, exist_ok=True)
    image_files = sorted(
        p for p in data_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    mask_by_stem = {
        p.stem: p
        for p in sem_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    } if sem_dir.is_dir() else {}
    for img_path in image_files:
        eq = np.asarray(Image.open(img_path).convert("RGB"))
        views = generate_planar_projections(eq, n_views)
        for k, view in enumerate(views):
            Image.fromarray(view.astype(np.uint8)).save(
                pers_images / f"{img_path.stem}_v{k:02d}.png"
            )
        mask_path = mask_by_stem.get(img_path.stem)
        if mask_path is not None:
            m = np.asarray(Image.open(mask_path).convert("L"))
            for k, view in enumerate(
                generate_planar_projections(m, n_views, nearest=True)
            ):
                Image.fromarray(view.astype(np.uint8)).save(
                    pers_masks / f"{img_path.stem}_v{k:02d}.png"
                )
    print(
        f"equirect: {len(image_files)} frames -> "
        f"{len(image_files) * n_views} planar views"
    )
    return pers_images, pers_masks


def main(args):
    data_dir = Path(args.data)
    sem_dir = Path(args.data_semantic)
    out = Path(args.output_dir)
    if args.camera_type == "equirectangular":
        data_dir, sem_dir = _expand_equirect(
            data_dir, sem_dir, out, args.images_per_equirect
        )
    images_out = out / "images"
    sem_out = out / "semantics"
    images_out.mkdir(parents=True, exist_ok=True)
    sem_out.mkdir(parents=True, exist_ok=True)

    image_files = sorted(
        p for p in data_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    if not image_files:
        raise FileNotFoundError(f"no images in {data_dir}")

    mask_by_stem = {
        p.stem: p
        for p in sem_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    }
    pairs = []
    for img in image_files:
        if img.stem not in mask_by_stem:
            raise FileNotFoundError(f"no mask for {img.name} in {sem_dir}")
        pairs.append((img, mask_by_stem[img.stem]))

    factors = [2**k for k in range(1, args.num_downscales + 1)]
    for f in factors:
        (out / f"images_{f}").mkdir(exist_ok=True)
        (out / f"semantics_{f}").mkdir(exist_ok=True)

    for img, mask in pairs:
        shutil.copy(img, images_out / img.name)
        # normalize masks to binary png (fruit_dataset.py:48-55 rules apply at load)
        m = np.asarray(Image.open(mask).convert("L"))
        binary = ((m > 125) * 255).astype(np.uint8)
        mask_name = img.stem + ".png"
        Image.fromarray(binary).save(sem_out / mask_name)
        for f in factors:
            _downscale(images_out / img.name, out / f"images_{f}" / img.name, f, False)
            _downscale(sem_out / mask_name, out / f"semantics_{f}" / mask_name, f, True)

    # merge semantic paths into transforms.json
    tpath = Path(args.transforms) if args.transforms else data_dir.parent / "transforms.json"
    if tpath.exists():
        with open(tpath) as fh:
            meta = json.load(fh)
        by_name = {Path(fr["file_path"]).name: fr for fr in meta.get("frames", [])}
        for img, _ in pairs:
            fr = by_name.get(img.name)
            if fr is not None:
                fr["file_path"] = f"images/{img.name}"
                fr["semantic_path"] = f"semantics/{img.stem}.png"
        meta["semantics"] = SEMANTIC_CLASSES
        with open(out / "transforms.json", "w") as fh:
            json.dump(meta, fh, indent=2)
        print(f"wrote {out/'transforms.json'} ({len(pairs)} frames)")
    else:
        print(
            f"WARNING: no transforms.json found at {tpath}; copied images+masks "
            "only. Run COLMAP (e.g. ns-process-data / colmap CLI) and re-run "
            "with --transforms."
        )
    print(f"processed {len(pairs)} image/mask pairs -> {out}")
