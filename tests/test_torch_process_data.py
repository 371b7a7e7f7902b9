"""The port's ``process-data`` (``scripts/process_data.py``) and
``data/equirect.py`` against the JAX package's (tests/test_equirect.py and
tests/test_dataparser.py's process-data test mirrored): on the same raw
input, perspective and 360 (8 and 14 views a frame), both commands write
the same tree, every image equal pixel for pixel and ``transforms.json``
equal; the projections equal the JAX package's bit for bit."""
import json

import numpy as np
import pytest
from PIL import Image

from fruitnerf_tpu.__main__ import main as jax_cli
from fruitnerf_tpu.data import equirect as jeq
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.data import equirect as teq


def _raw(root, n, shape, with_transforms=True):
    """Raw frames (PNG and JPEG) and grey-level masks (the command binarises
    them at > 125), with a transforms.json keyed by the images' names."""
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    rng = np.random.RandomState(0)
    frames = []
    for i in range(n):
        name = f"frame_{i:03d}." + ("jpg" if i % 3 == 2 else "png")
        Image.fromarray(rng.randint(0, 255, (*shape, 3), np.uint8)).save(root / "images" / name)
        Image.fromarray(rng.randint(0, 255, shape, np.uint8)).save(
            root / "masks" / f"frame_{i:03d}.png")
        frames.append({"file_path": f"./raw_images/{name}", "transform_matrix": np.eye(4).tolist()})
    meta = {"fl_x": 40.0, "fl_y": 41.0, "cx": 24.0, "cy": 16.0, "w": shape[1], "h": shape[0],
            "frames": frames, "train_filenames": [f["file_path"] for f in frames[:-1]]}
    if with_transforms:
        (root / "transforms.json").write_text(json.dumps(meta))
    return root


def _run(cli, raw, out, *extra):
    argv = ["process-data", "--data", str(raw / "images"), "--data-semantic",
            str(raw / "masks"), "--output-dir", str(out), *map(str, extra)]
    if (raw / "transforms.json").exists():
        argv += ["--transforms", str(raw / "transforms.json")]
    cli(argv)


def _same_tree(a, b):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and files_a
    for rel in files_a:
        if rel.suffix == ".json":
            assert json.loads((a / rel).read_text()) == json.loads((b / rel).read_text())
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(a / rel)),
                                          np.asarray(Image.open(b / rel)), err_msg=str(rel))
    return files_a


@pytest.mark.parametrize("downscales", [1, 2])
def test_perspective_tree_equals_jax(tmp_path, downscales):
    raw = _raw(tmp_path / "raw", 6, (32, 48))
    _run(jax_cli, raw, tmp_path / "jax", "--num-downscales", downscales)
    _run(port_cli, raw, tmp_path / "port", "--num-downscales", downscales)
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    meta = json.loads((tmp_path / "port" / "transforms.json").read_text())
    assert meta["semantics"] == ["apple", "stuff"] and len(meta["train_filenames"]) == 5
    assert all(fr["semantic_path"] == f"semantics/{fr['file_path'][7:-4]}.png"
               for fr in meta["frames"])
    assert sum(str(f).startswith(f"images_{2 ** downscales}/") for f in files) == 6
    mask = np.asarray(Image.open(tmp_path / "port" / "semantics" / "frame_000.png"))
    raw_mask = np.asarray(Image.open(raw / "masks" / "frame_000.png"))
    np.testing.assert_array_equal(mask, (raw_mask > 125) * 255)  # binarised
    half = Image.open(tmp_path / "port" / "images_2" / "frame_001.png")
    assert half.size == (24, 16)


def test_without_transforms_copies_the_frames(tmp_path):
    raw = _raw(tmp_path / "raw", 3, (16, 16), with_transforms=False)
    _run(jax_cli, raw, tmp_path / "jax", "--num-downscales", 1)
    _run(port_cli, raw, tmp_path / "port", "--num-downscales", 1)
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert not any(f.name == "transforms.json" for f in files)


@pytest.mark.parametrize("views", [8, 14])
def test_equirect_tree_equals_jax(tmp_path, views):
    raw = _raw(tmp_path / "raw", 2, (32, 64), with_transforms=False)
    extra = ("--camera-type", "equirectangular", "--images-per-equirect", views,
             "--num-downscales", 1)
    _run(jax_cli, raw, tmp_path / "jax", *extra)
    _run(port_cli, raw, tmp_path / "port", *extra)
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert sum(str(f).startswith("images/") for f in files) == 2 * views


def _panorama(h=32, w=64):
    lon = np.linspace(0, 255, w, endpoint=False)[None, :].repeat(h, 0)
    lat = np.linspace(0, 255, h)[:, None].repeat(w, 1)
    return np.stack([lon, lat, np.zeros_like(lon)], -1)


@pytest.mark.parametrize("views", [8, 14])
@pytest.mark.parametrize("nearest", [False, True])
def test_planar_projections_equal_jax(views, nearest):
    eq = _panorama()
    if nearest:
        eq = (np.random.RandomState(2).rand(32, 64) > 0.5).astype(np.uint8) * 255
    got = teq.generate_planar_projections(eq, views, out_size=12, nearest=nearest)
    want = jeq.generate_planar_projections(eq, views, out_size=12, nearest=nearest)
    assert len(got) == len(want) == views
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teq.view_directions(views) == jeq.view_directions(views)
    assert teq.perspective_size(1440) == jeq.perspective_size(1440) == 480
