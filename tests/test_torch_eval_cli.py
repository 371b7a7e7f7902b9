"""The port's ``eval`` and ``render`` CLIs. ``eval`` against the JAX
package's: the JAX CLI trains 5 smoke steps on a capture and evaluates the
run (tests/test_eval_cli.py's fixture); its ``ckpt_*.msgpack`` is read
through the bridge (``engine/checkpoints.py:read_jax_checkpoint``) into a
port run, which the port's ``eval --device cpu`` evaluates over the same
cameras. Also the two reference faults the port fixes: ``render`` applies
the manifest's config overrides, and a run trained at
``--downscale-factor 2`` is evaluated and rendered at that resolution."""
import json

import numpy as np
import pytest
from PIL import Image

from fruitnerf_tpu.__main__ import main as jax_cli
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.configs import run_preset
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.engine.trainer import init_train_state

# float32 renders of one set of parameters by two libraries: the fine
# samples follow the proposal weights (anneal 1 at eval), which moves
# depths by up to 1e-4 (tests/test_torch_train_step.py); observed PSNR
# within 3.2e-8 and SSIM within 3.5e-6 relative, both IoUs equal.
METRIC_RTOL = 1e-4
IOU_ATOL = 1e-3


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """tests/test_eval_cli.py's run: 8 cameras of a 3-fruit scene at 32^2,
    written with Pillow; 5 smoke steps at split 0.75; the JAX eval JSON."""
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "semantics").mkdir()
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=8, image_size=32))
    frames = []
    for i in range(scene["images"].shape[0]):
        name = f"frame_{i:03d}.png"
        Image.fromarray((scene["images"][i] * 255).astype(np.uint8)).save(root / "images" / name)
        Image.fromarray((scene["masks"][i] * 255).astype(np.uint8)).save(root / "semantics" / name)
        c2w = np.eye(4)
        c2w[:3] = scene["poses"][i]
        frames.append({"file_path": f"images/{name}", "semantic_path": f"semantics/{name}",
                       "transform_matrix": c2w.tolist()})
    meta = {"fl_x": float(scene["fx"]), "fl_y": float(scene["fy"]), "cx": float(scene["cx"]),
            "cy": float(scene["cy"]), "w": int(scene["width"]), "h": int(scene["height"]),
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    out = tmp_path_factory.mktemp("jax_run")
    jax_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(root), "--output-dir", str(out),
             "--max-iters", "5", "--train-rays-per-batch", "128", "--train-split-fraction", "0.75"])
    jax_cli(["eval", "--load-dir", str(out), "--data", str(root), "--output",
             str(out / "eval.json")])
    return root, out, json.loads((out / "eval.json").read_text())


def _port_run_from_jax(jax_dir, port_dir):
    """The JAX run's manifest and latest msgpack as a port run."""
    manifest = json.loads((jax_dir / "manifest.json").read_text())
    config = run_preset(manifest["preset"], manifest["num_images"], manifest["variant"])
    (ckpt,) = sorted((jax_dir / "checkpoints").glob("ckpt_*.msgpack"))[-1:]
    params, step = ck.read_jax_checkpoint(ckpt, config.model, "cpu")
    state = init_train_state(config, manifest["num_images"], "cpu", params=params)
    state.step = step
    ck.write_manifest(
        port_dir, manifest["preset"], np.asarray(manifest["dataparser_transform"]),
        manifest["dataparser_scale"], np.asarray(manifest["scene_aabb"]),
        manifest["num_images"], config.model.field.encoding_config,
        semantics_classes=manifest["semantics_classes"],
        extra={k: manifest[k] for k in ("variant", "max_iters", "train_split_fraction")})
    ck.save_checkpoint(port_dir / "checkpoints", state)
    return step


def test_eval_of_a_jax_checkpoint_equals_jax_eval(jax_run, tmp_path):
    root, jax_dir, want = jax_run
    step = _port_run_from_jax(jax_dir, tmp_path / "port_run")
    out = tmp_path / "metrics.json"
    port_cli(["eval", "--load-dir", str(tmp_path / "port_run"), "--data", str(root),
              "--output", str(out), "--device", "cpu"])
    got = json.loads(out.read_text())
    assert got["step"] == want["step"] == step == 5
    assert got["num_images_evaluated"] == want["num_images_evaluated"] == 2  # 8 cams, split 0.75
    for k in ("psnr", "ssim", "iou_reference_quirk"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    assert abs(got["iou"] - want["iou"]) <= IOU_ATOL
    assert got["device"] == "cpu"


@pytest.mark.parametrize("split, count", [("train", 6), ("all", 8)])
def test_eval_splits(jax_run, tmp_path, split, count):
    root, jax_dir, _ = jax_run
    _port_run_from_jax(jax_dir, tmp_path / "port_run")
    out = tmp_path / "metrics.json"
    port_cli(["eval", "--load-dir", str(tmp_path / "port_run"), "--data", str(root),
              "--split", split, "--output", str(out), "--device", "cpu"])
    stats = json.loads(out.read_text())
    assert stats["num_images_evaluated"] == count
    assert all(np.isfinite(stats[k]) for k in ("psnr", "ssim", "iou", "num_rays_per_sec", "fps"))


def test_train_cli_writes_final_eval_averages(jax_run, tmp_path):
    """tests/test_eval_cli.py's second case, on the port's train CLI: the
    final eval averages over the parsed val cameras, LPIPS included when
    weights are given."""
    from test_lpips import _tiny_npz

    root, _, _ = jax_run
    weights, _ = _tiny_npz(tmp_path)
    run = tmp_path / "run"
    port_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(root), "--output-dir", str(run),
              "--max-iters", "3", "--train-rays-per-batch", "128", "--train-split-fraction", "0.75",
              "--lpips-weights", str(weights), "--device", "cpu"])
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    finals = [r for r in rows if any(k.startswith("final_eval_") for k in r)]
    assert finals and np.isfinite(finals[-1]["final_eval_psnr"])
    assert 0.0 <= finals[-1]["final_eval_lpips"] < np.inf


def test_render_applies_the_manifest_overrides(tmp_path):
    """A run trained with shape-changing overrides (a 512-row, 4-level
    table through orchard-e2e) restores in render, which rebuilds the
    config with them (fruitnerf_tpu/scripts/render.py:50-54 does not)."""
    from test_torch_orchard_e2e import TOY

    run = tmp_path / "run"
    port_cli(["orchard-e2e", *TOY, "--iters", "2", "--output-dir", str(run)])
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["config_overrides"]["table_size"] == 512
    port_cli(["render", "--load-dir", str(run), "--data", "synthetic", "--output-dir",
              str(tmp_path / "r"), "--cameras", "0", "3", "--device", "cpu"])
    for cam in (0, 3):
        for panel in ("rgb", "depth", "acc", "semantics", "colormap"):
            img = Image.open(tmp_path / "r" / f"cam{cam:03d}_{panel}.png")
            assert (img.mode, img.size) == ("RGB", (128, 128)), panel


def test_eval_and_render_use_the_trained_downscale_factor(tmp_path, monkeypatch):
    """A run trained at --downscale-factor 2 (the images_2/ level) is
    evaluated and rendered at half resolution; the JAX twin re-parses at the
    automatic factor, here 1."""
    from fruitnerf_tpu_torch.data.fixture import write_scene_capture
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig as TorchScene
    from fruitnerf_tpu_torch.data.synthetic import render_scene as torch_render_scene

    scene = torch_render_scene(TorchScene(num_fruits=3, num_cameras=6, image_size=32), device="cpu")
    root = tmp_path / "capture"
    write_scene_capture(scene, root, eval_fraction=0.2)
    for src, dst in (("images", "images_2"), ("masks", "masks_2")):
        (root / dst).mkdir()
        for f in sorted((root / src).iterdir()):
            Image.fromarray(np.asarray(Image.open(f))[::2, ::2]).save(root / dst / f.name)
    run = tmp_path / "run"
    port_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(root), "--output-dir", str(run),
              "--max-iters", "2", "--train-rays-per-batch", "64", "--downscale-factor", "2",
              "--device", "cpu"])
    assert json.loads((run / "manifest.json").read_text())["downscale_factor"] == 2
    seen = []
    real = trainer.evaluate_all
    monkeypatch.setattr(trainer, "evaluate_all",
                        lambda params, data, *a, **k: seen.append(data.image_shape)
                        or real(params, data, *a, **k))
    port_cli(["eval", "--load-dir", str(run), "--data", str(root), "--device", "cpu"])
    assert seen == [(16, 16)]
    port_cli(["render", "--load-dir", str(run), "--data", str(root), "--output-dir",
              str(tmp_path / "r"), "--device", "cpu"])
    assert Image.open(tmp_path / "r" / "cam000_rgb.png").size == (16, 16)
