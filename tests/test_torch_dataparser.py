"""The port's capture data layer against the JAX package's, on the JAX
suite's toy capture (tests/test_dataparser.py: six 32 x 48 frames with
fruit masks, fx 40, fy 41, k1 0.01), extended with ``applied_transform``,
``applied_scale``, explicit splits and an ``images_2/`` level:
``cameras/poses.py`` and ``parse_transforms`` (every ``ParsedScene`` field
exactly equal), ``dataset_from_parsed`` (exactly equal), the reference's
mask rule, the train CLI's split wiring, and one smoke-preset train step on
the capture, against JAX's step on the same draws (the first step to reach
the undistortion of ``cameras/cameras.py`` with k1 != 0)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_hash_train import HASH_GRAD_RTOL, _configs
from test_torch_train_step import LOSS_RTOL, _grad_errors, _jax_draws

from fruitnerf_tpu.cameras import poses as jax_poses
from fruitnerf_tpu.data import dataparser as jax_dp
from fruitnerf_tpu.data.builder import dataset_from_parsed as jax_dataset_from_parsed
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu_torch import bridge
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.cameras import poses
from fruitnerf_tpu_torch.data import dataparser as dp
from fruitnerf_tpu_torch.data.builder import dataset_from_parsed
from fruitnerf_tpu_torch.data.poses_io import normalize_mask_array
from fruitnerf_tpu_torch.engine import trainer

N = 6


def _write_toy(root, with_half=False):
    """tests/test_dataparser.py's toy_dataset; with ``with_half`` also an
    ``images_2/`` + ``semantics_2/`` level at 16 x 24."""
    (root / "images").mkdir()
    (root / "semantics").mkdir()
    rng = np.random.RandomState(0)
    frames = []
    for i in range(N):
        name = f"frame_{i:03d}.png"
        img = rng.randint(0, 255, (32, 48, 3), np.uint8)
        mask = (rng.rand(32, 48) > 0.7).astype(np.uint8) * 255
        Image.fromarray(img).save(root / "images" / name)
        Image.fromarray(mask).save(root / "semantics" / name)
        if with_half:
            for d, a in (("images_2", img), ("semantics_2", mask)):
                (root / d).mkdir(exist_ok=True)
                Image.fromarray(a[::2, ::2]).save(root / d / name)
        c2w = np.eye(4)
        c2w[:3, 3] = rng.randn(3) * 2
        frames.append({"file_path": f"images/{name}", "semantic_path": f"semantics/{name}",
                       "transform_matrix": c2w.tolist()})
    meta = {"fl_x": 40.0, "fl_y": 41.0, "cx": 24.0, "cy": 16.0, "w": 48, "h": 32, "k1": 0.01,
            "k2": 0.0, "frames": frames, "semantics": ["apple", "stuff"]}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.fixture()
def toy_dataset(tmp_path):
    return _write_toy(tmp_path)


def _edit(root, **changes):
    meta = json.loads((root / "transforms.json").read_text())
    meta.update(changes)
    (root / "transforms.json").write_text(json.dumps(meta))


APPLIED = np.array([[0, 1, 0, 0.5], [1, 0, 0, -0.25], [0, 0, -1, 2.0]], float)
VARIANTS = {
    "plain": {},
    "applied": {"applied_transform": APPLIED.tolist(), "applied_scale": 0.5},
    "applied_4x4": {"applied_transform": np.vstack([APPLIED, [0, 0, 0, 1]]).tolist()},
    "explicit_split": {"train_filenames": ["frame_000.png", "images/frame_001.png", "frame_004.png"],
                       "val_filenames": ["frame_002.png"]},
    "test_split": {"train_filenames": ["frame_003.png"], "test_filenames": ["frame_005.png"]},
    "frame_intrinsics": {},
}


def _assert_parsed_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), f.name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("config", [
    {}, {"train_split_fraction": 0.5}, {"downscale_factor": 2}, {"scale_factor": 2.0},
    {"orientation_method": "none", "center_method": "none", "auto_scale_poses": False},
], ids=["default", "split_0.5", "downscale_2", "scale_2", "no_normalisation"])
def test_parse_transforms_equals_jax(tmp_path, variant, config):
    """Every ParsedScene field, exactly: paths, float32 poses and
    intrinsics, int32 sizes, splits, the float32 transform and the scale."""
    root = _write_toy(tmp_path, with_half=True)
    _edit(root, **VARIANTS[variant])
    if variant == "frame_intrinsics":  # per-frame intrinsics override the global ones
        meta = json.loads((root / "transforms.json").read_text())
        for i, fr in enumerate(meta["frames"]):
            fr.update(fl_x=40.0 + i, cx=24.5, k2=0.001 * i, p1=1e-4)
        (root / "transforms.json").write_text(json.dumps(meta))
    got = dp.parse_transforms(dp.DataParserConfig(data_dir=root, **config))
    want = jax_dp.parse_transforms(jax_dp.DataParserConfig(data_dir=root, **config))
    _assert_parsed_equal(got, want)
    if "downscale_factor" in config:
        assert got.image_paths[0].parent.name == "images_2"
        assert got.mask_paths[0].parent.name == "semantics_2"
        assert list(got.width) == [24] * N


@pytest.mark.parametrize("up", [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0.3, -0.2, 0.9),
                                (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0)],
                         ids=["aligned", "opposite", "general", "x", "minus_x"])
def test_rotation_matrix_between_equals_jax(up):
    """Rodrigues, its aligned case and both axes of its 180-degree case."""
    a, b = np.array(up), np.array([0.0, 0.0, 1.0])
    for x, y in ((a, b), (b, a)):
        r = poses.rotation_matrix_between(x, y)
        np.testing.assert_array_equal(r, jax_poses.rotation_matrix_between(x, y))
        np.testing.assert_allclose(r @ (x / np.linalg.norm(x)), y / np.linalg.norm(y), atol=1e-12)


def test_pose_normalisation_equals_jax():
    rng = np.random.default_rng(0)
    p = np.tile(np.eye(4), (7, 1, 1))
    p[:, :3, :3] = np.linalg.qr(rng.standard_normal((7, 3, 3)))[0]
    p[:, :3, 3] = rng.standard_normal((7, 3)) * 3
    for method, center in (("up", "poses"), ("none", "none"), ("up", "none")):
        got = poses.auto_orient_and_center_poses(p, method, center)
        want = jax_poses.auto_orient_and_center_poses(p, method, center)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    (o, s), (jo, js) = poses.auto_scale_poses(got[0]), jax_poses.auto_scale_poses(want[0])
    np.testing.assert_array_equal(o, jo)
    assert s == js
    with pytest.raises(ValueError, match="center_method"):
        poses.auto_orient_and_center_poses(p, "up", "focus")


def test_parse_transforms_full(toy_dataset):
    parsed = dp.parse_transforms(dp.DataParserConfig(data_dir=toy_dataset))
    assert len(parsed.image_paths) == 6
    np.testing.assert_allclose(parsed.fx, 40.0)
    np.testing.assert_allclose(parsed.fy, 41.0)
    np.testing.assert_allclose(parsed.distortion[:, 0], 0.01)
    # split: ceil(6*0.9)=6 -> degenerate all-train, eval falls back to frame 0
    assert list(parsed.train_indices) == list(range(6)) and list(parsed.eval_indices) == [0]
    assert np.abs(parsed.poses[:, :3, 3]).max() <= 1.0 + 1e-5
    assert parsed.dataparser_scale > 0 and parsed.dataparser_transform.shape == (3, 4)
    assert parsed.semantics_classes == ("apple", "stuff")
    imgs, masks = parsed.load_images([0, 1]), parsed.load_masks([0, 1])
    assert imgs.shape == (2, 32, 48, 3) and imgs.max() <= 1.0
    assert masks.shape == (2, 32, 48) and set(np.unique(masks)) <= {0.0, 1.0}


def test_parse_transforms_split_fraction(toy_dataset):
    parsed = dp.parse_transforms(dp.DataParserConfig(data_dir=toy_dataset, train_split_fraction=0.5))
    assert len(parsed.train_indices) == 3 and len(parsed.eval_indices) == 3
    assert not set(parsed.train_indices) & set(parsed.eval_indices)


def test_parse_transforms_explicit_split(toy_dataset):
    _edit(toy_dataset, train_filenames=["frame_000.png", "frame_001.png"],
          val_filenames=["frame_002.png"])
    parsed = dp.parse_transforms(dp.DataParserConfig(data_dir=toy_dataset))
    assert list(parsed.train_indices) == [0, 1] and list(parsed.eval_indices) == [2]


def test_applied_transform_and_scale_honored(toy_dataset):
    """applied_transform/applied_scale (fruitnerf_dataparser.py:275-282)
    compose into the REPORTED transform and scale only; training poses
    are untouched."""
    base = dp.parse_transforms(dp.DataParserConfig(data_dir=toy_dataset))
    _edit(toy_dataset, applied_transform=APPLIED.tolist(), applied_scale=0.5)
    parsed = dp.parse_transforms(dp.DataParserConfig(data_dir=toy_dataset))
    np.testing.assert_allclose(parsed.poses, base.poses, atol=1e-6)
    np.testing.assert_allclose(parsed.dataparser_scale, base.dataparser_scale * 0.5, rtol=1e-6)
    b4 = np.concatenate([base.dataparser_transform, [[0, 0, 0, 1]]], axis=0)
    np.testing.assert_allclose(parsed.dataparser_transform, (b4 @ np.vstack([APPLIED, [0, 0, 0, 1]]))[:3],
                               atol=1e-9)


def test_mask_normalization_rules():
    # fruit_dataset.py:48-55 rules
    jpg_mask = np.array([[0, 120, 130, 255]], np.uint8)
    np.testing.assert_array_equal(normalize_mask_array(jpg_mask, is_jpg=True), [[0, 0, 1, 1]])
    np.testing.assert_allclose(normalize_mask_array(np.array([[0, 255]], np.uint8)), [[0, 1.0]])
    np.testing.assert_allclose(normalize_mask_array(np.array([[0.0, 1.0]])), [[0, 1.0]])


def test_train_cli_wires_preset_split_fraction(tmp_path, toy_dataset, monkeypatch):
    """Regression (tests/test_dataparser.py:119): the split fraction must
    reach the dataparser, through the port's CLI."""
    seen = {}
    orig = dp.parse_transforms

    def spy(config):
        seen["fraction"] = config.train_split_fraction
        return orig(config)

    monkeypatch.setattr(dp, "parse_transforms", spy)  # train.py imports it inside main()
    port_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(toy_dataset),
              "--output-dir", str(tmp_path / "run"), "--max-iters", "1",
              "--train-rays-per-batch", "64", "--train-split-fraction", "0.5", "--device", "cpu"])
    assert seen["fraction"] == 0.5
    manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
    assert manifest["train_split_fraction"] == 0.5 and manifest["downscale_factor"] is None


def test_dataset_from_parsed_equals_jax(tmp_path):
    """Images, masks, every camera array and the train indices."""
    root = _write_toy(tmp_path)
    _edit(root, train_filenames=[f"frame_00{i}.png" for i in (0, 2, 3, 5)],
          val_filenames=["frame_001.png"])
    meta = json.loads((root / "transforms.json").read_text())
    meta["frames"][3].update(fl_x=44.0, p2=2e-3)
    (root / "transforms.json").write_text(json.dumps(meta))
    parsed = dp.parse_transforms(dp.DataParserConfig(data_dir=root))
    got = dataset_from_parsed(parsed, "cpu")
    want = jax_dataset_from_parsed(jax_dp.parse_transforms(jax_dp.DataParserConfig(data_dir=root)))
    for name in ("images", "masks", "train_indices"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.images.dtype == torch.uint8 and got.masks.dtype == torch.uint8
    for f in dataclasses.fields(got.cameras):
        np.testing.assert_array_equal(getattr(got.cameras, f.name).numpy(),
                                      np.asarray(getattr(want.cameras, f.name)), err_msg=f.name)
    assert float(got.cameras.distortion[3, 5]) == np.float32(2e-3)


@pytest.fixture(scope="module")
def capture_step(tmp_path_factory):
    root = _write_toy(tmp_path_factory.mktemp("toy"))
    jcfg, tcfg = _configs("smoke")
    jdata = jax_dataset_from_parsed(jax_dp.parse_transforms(jax_dp.DataParserConfig(data_dir=root)))
    tdata = dataset_from_parsed(dp.parse_transforms(dp.DataParserConfig(data_dir=root)), "cpu")
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N)
    return dict(jcfg=jcfg, tcfg=tcfg, jdata=jdata, tdata=tdata, jstate=jstate,
                params0=jax.tree.map(np.array, jstate.params),
                step_fn=jtrainer.make_train_step(jcfg))


def test_one_smoke_step_on_the_capture_matches_jax(capture_step):
    """Step 0 of the smoke preset on the toy capture (k1 = 0.01, so every
    ray goes through the undistortion), the JAX step's draws injected: each
    loss term at LOSS_RTOL of itself or of the total, every gradient leaf at
    HASH_GRAD_RTOL of its max (tests/test_torch_hash_train.py's tolerances)."""
    s = capture_step
    key = jax.random.PRNGKey(1)
    jstate = jax.tree.map(jnp.array, s["jstate"])
    jnew, jm = s["step_fn"](jstate, s["jdata"], key)
    tcfg = s["tcfg"]
    tstate = trainer.init_train_state(
        tcfg, N, "cpu", params=bridge.params_from_jax(s["params0"], tcfg.model, "cpu"))
    tm = trainer.train_step(tstate, s["tdata"], tcfg, draws=_jax_draws(key, 0, s["jcfg"], s["jdata"]))
    atol = LOSS_RTOL * float(jm["total_loss"])
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "total_loss",
              "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=atol, err_msg=k)
    for path, (rel, _, _) in _grad_errors(jnew, tstate, tcfg.model).items():
        assert rel <= HASH_GRAD_RTOL, (path, rel)
