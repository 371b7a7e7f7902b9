"""The disk capture workflow on the port's CLI (``python -m
fruitnerf_tpu_torch``), each command in a fresh interpreter where JAX and
the JAX package cannot be imported, on the CPU through ``--device cpu``:
the port's ``write_scene_capture`` writes a capture tree, then ``train --data <tree>`` -> ``eval`` -> ``render`` ->
``export`` -> ``count``. The manifest is held to the JAX package's
``parse_transforms`` of the same tree, and the port's capture writer to the
JAX package's. ``process-data`` then a few ``fruit_nerf_big`` steps and
``eval`` run the same way. The mirror of tests/test_disk_e2e.py from its
step 2 (800 steps, its cloud and count checks, on the capture as written)
is marked ``slow``."""
import json

import numpy as np
import pytest
from PIL import Image
from test_torch_orchard_e2e import cli

from fruitnerf_tpu.data.dataparser import DataParserConfig, parse_transforms
from fruitnerf_tpu.data.fixture import write_scene_capture as jax_write_scene_capture
from fruitnerf_tpu.data.poses_io import load_image, load_mask
from fruitnerf_tpu_torch.data.fixture import write_scene_capture
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.export.ply import read_ply

FRUIT_RADIUS = 0.14
NUM_FRUITS = 4


def _scene(num_cameras, image_size):
    return render_scene(SyntheticSceneConfig(
        num_fruits=NUM_FRUITS, fruit_radius=FRUIT_RADIUS, num_cameras=num_cameras,
        image_size=image_size, num_leaves=6), device="cpu")


def test_capture_writer_equals_jax(tmp_path):
    """The same transforms.json, and frames that decode (in Pillow, through
    the JAX package's loaders) to the same arrays."""
    scene = _scene(7, 24)
    write_scene_capture(scene, tmp_path / "port", eval_fraction=0.3, applied_scale=0.25)
    jax_write_scene_capture(scene, tmp_path / "jax", eval_fraction=0.3, applied_scale=0.25)
    meta = json.loads((tmp_path / "port" / "transforms.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "transforms.json").read_text())
    assert len(meta["val_filenames"]) == 2 and meta["applied_scale"] == 0.25
    for fr in meta["frames"]:
        for key, load in (("file_path", load_image), ("semantic_path", load_mask)):
            np.testing.assert_array_equal(load(tmp_path / "port" / fr[key]),
                                          load(tmp_path / "jax" / fr[key]))


def _flow(tmp_path, scene, iters, export_args, applied_scale=None):
    """The workflow's commands on ``scene``; returns (tree, run, export dir)."""
    tree, run, exp = tmp_path / "capture", tmp_path / "run", tmp_path / "export"
    write_scene_capture(scene, tree, eval_fraction=0.15, applied_scale=applied_scale)
    cli("train", "--preset", "fruit_nerf_smoke", "--data", tree, "--output-dir", run,
        "--max-iters", iters, "--sparsity-loss", 0.01, "--device", "cpu")
    cli("eval", "--load-dir", run, "--data", tree, "--output", tmp_path / "eval.json",
        "--device", "cpu")
    cli("render", "--load-dir", run, "--data", tree, "--output-dir", tmp_path / "render",
        "--cameras", 0, "--device", "cpu")
    cli("export", "--load-dir", run, "--output-dir", exp, *export_args, "--device", "cpu")
    return tree, run, exp


def _count(exp, out_json, r):
    """tests/test_disk_e2e.py's count flags, at fruit radius ``r``."""
    cli("count", "--cloud", exp / "semantic_colormap.ply", "--eps", 0.6 * r, "--min-samples", 4,
        "--remove-outliers-nb-points", 3, "--remove-outliers-radius", 0.45 * r,
        "--down-sample", 0.05 * r, "--cluster-merge-distance", 1.2 * r,
        "--template-size", r / 0.04, "--gt-count", NUM_FRUITS, "--output", out_json)
    (row,) = json.loads(out_json.read_text()).values()
    return row


def test_disk_workflow_runs_without_jax(tmp_path):
    """About 20 smoke steps: every command runs and writes what the next
    reads; the manifest equals the JAX package's parse of the tree."""
    scene = _scene(12, 32)
    tree, run, exp = _flow(tmp_path, scene, 20, [
        "--num-points-per-side", 24, "--bounding-box-min", -0.55, -0.55, -0.55,
        "--bounding-box-max", 0.55, 0.55, 0.55, "--density-threshold", 0.0,
        "--semantic-logit-threshold", -100, "--colormap-prob-threshold", 0.0], applied_scale=0.5)
    manifest = json.loads((run / "manifest.json").read_text())
    want = parse_transforms(DataParserConfig(data_dir=tree, train_split_fraction=0.9))
    np.testing.assert_array_equal(np.asarray(manifest["dataparser_transform"], np.float32),
                                  want.dataparser_transform)
    assert manifest["dataparser_scale"] == want.dataparser_scale
    np.testing.assert_array_equal(manifest["scene_aabb"], want.scene_aabb)
    assert manifest["semantics_classes"] == list(want.semantics_classes)
    assert manifest["num_images"] == 12 and manifest["downscale_factor"] is None
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(rows[-1]["final_eval_psnr"])
    stats = json.loads((tmp_path / "eval.json").read_text())
    assert stats["num_images_evaluated"] == len(want.eval_indices) == 2
    assert stats["step"] == 20 and np.isfinite(stats["psnr"])
    for panel in ("rgb", "depth", "acc", "semantics", "colormap"):
        assert Image.open(tmp_path / "render" / f"cam000_{panel}.png").size == (32, 32)
    cloud = read_ply(exp / "semantic_colormap.ply")["points"]
    assert len(cloud) == 24**3  # thresholds that keep every probe
    # un-normalization: x 2 / dataparser_scale, so the box's corner lands at
    # 0.55 * 2 / scale
    np.testing.assert_allclose(np.abs(cloud).max(), 0.55 * 2 / manifest["dataparser_scale"],
                               rtol=1e-5)
    row = _count(exp, tmp_path / "count.json", FRUIT_RADIUS)
    assert row["count"] >= 0 and row["cloud_used"].endswith("semantic_colormap.ply")


@pytest.mark.slow
def test_disk_pipeline_end_to_end(tmp_path):
    """tests/test_disk_e2e.py from its step 2 on: 800 smoke steps on the
    capture, an export in the crop box at the smoke-scale thresholds, more
    than half the fruit cloud within two fruit radii of the GT centres
    mapped by the manifest's transform, and a count in [1, 3 x GT]."""
    scene = _scene(20, 64)
    tree, run, exp = _flow(tmp_path, scene, 800, [
        "--num-points-per-side", 96, "--num-rays-per-batch", 9216,
        "--bounding-box-min", -0.55, -0.55, -0.55, "--bounding-box-max", 0.55, 0.55, 0.55,
        "--density-threshold", 0.1, "--semantic-logit-threshold", 1.25,
        "--colormap-prob-threshold", 0.75])
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["dataparser_scale"] > 0
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    finals = [m for m in rows if any(k.startswith("final_eval") for k in m)]
    assert finals and finals[-1]["final_eval_psnr"] > 8.0
    pts = read_ply(exp / "semantic_colormap.ply")["points"]
    assert len(pts) > 50, "export produced an (almost) empty fruit cloud"
    tr = np.asarray(manifest["dataparser_transform"], np.float64)
    gt = np.asarray(scene["fruit_centers"], np.float64) @ tr[:, :3].T + tr[:, 3]
    d = np.linalg.norm(pts[:, None, :] - gt[None], axis=-1).min(axis=1)
    assert float((d < 2.0 * FRUIT_RADIUS).mean()) > 0.5
    row = _count(exp, tmp_path / "count.json", FRUIT_RADIUS)
    assert 1 <= row["count"] <= 3 * NUM_FRUITS, row


def test_process_data_then_big_preset_without_jax(tmp_path):
    """process-data on a raw capture, three ``fruit_nerf_big`` steps (the
    preset's RAdam, its 0.99 split and its full layout, at 64 rays) on the
    processed tree, then eval of the run."""
    scene = _scene(10, 24)
    raw, tree, run = tmp_path / "raw", tmp_path / "capture", tmp_path / "run"
    write_scene_capture(scene, raw, eval_fraction=0.2)
    cli("process-data", "--data", raw / "images", "--data-semantic", raw / "masks",
        "--transforms", raw / "transforms.json", "--output-dir", tree, "--num-downscales", 1)
    meta = json.loads((tree / "transforms.json").read_text())
    assert all(fr["semantic_path"].startswith("semantics/") for fr in meta["frames"])
    assert len(meta["val_filenames"]) == 2
    cli("train", "--preset", "fruit_nerf_big", "--data", tree, "--output-dir", run,
        "--max-iters", 3, "--train-rays-per-batch", 64, "--device", "cpu")
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["preset"] == "fruit_nerf_big" and manifest["num_train_images"] == 8
    cli("eval", "--load-dir", run, "--data", tree, "--output", tmp_path / "eval.json",
        "--device", "cpu")
    stats = json.loads((tmp_path / "eval.json").read_text())
    assert stats["step"] == 3 and stats["num_images_evaluated"] == 2
    assert np.isfinite(stats["psnr"])
