"""The port's stock RGB point cloud (``export/rgb_pointcloud.py``) against
the JAX package's, on the CPU, with the smoke preset's parameters made by
JAX and bridged into the port: ``backproject_camera`` on the same cameras
and panels, the ``render_camera`` panels it back-projects, and
``export_rgb_pointcloud`` whole (gate, subsample, outlier cleaning,
un-normalisation). Then ``export --mode pointcloud --device cpu`` on a
trained run, and the fault the port repairs: a capture run trained at a
forced downscale factor renders its cloud at that resolution (the JAX
command parses the capture at the automatic factor)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import cameras_from_scene as jax_cameras_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.export import rgb_pointcloud as jrgb
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.data.builder import cameras_from_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.export import rgb_pointcloud
from fruitnerf_tpu_torch.export.ply import read_ply

N_CAMS = 4
SIZE = 24
# The smoke preset's hash tables drawn uniform in +-TABLE_SCALE (its init is
# +-1e-4, which renders every pixel alike): accumulation then varies over
# 0.968-0.974 between pixels, so the gate splits them.
TABLE_SCALE = 0.1
BACKPROJECT_ATOL = 1e-6  # same float32 rays and panels through numpy on both sides
# float32 renders of one set of parameters by two libraries; observed gaps
# 4.8e-7 (rgb), 4.2e-7 (depth), 5.4e-7 (accumulation). The accumulation
# gate's threshold keeps every pixel farther than this from it.
RENDER_ATOL = 2e-6
POINT_ATOL = 1e-5  # exported points (x 2 / scale of depth-scaled rays)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: with six test workers on the
    host, torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_tables(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _with_tables(v, rng, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_tables(v, rng, (*path, i)) for i, v in enumerate(tree))
    if path[-1] == "hash_table":
        return rng.uniform(-TABLE_SCALE, TABLE_SCALE, tree.shape).astype(np.float32)
    return tree


def bridged_smoke(num_images: int, seed: int = 0):
    """The JAX smoke preset's parameters (hash tables redrawn at
    TABLE_SCALE) on both sides -> (JAX config, JAX params, port config,
    port params on the CPU)."""
    jcfg = jconfigs.fruit_nerf_smoke(num_images)
    tcfg = configs.fruit_nerf_smoke(num_images)
    params = jax.tree.map(np.array, jtrainer.init_train_state(
        jax.random.PRNGKey(seed), jcfg, num_images).params)
    params = _with_tables(params, np.random.RandomState(seed))
    return (jcfg, jax.tree.map(jnp.asarray, params), tcfg,
            bridge.params_from_jax(params, tcfg.model, "cpu"))


@pytest.fixture(scope="module")
def models():
    scene = render_scene(SyntheticSceneConfig(
        num_fruits=3, num_cameras=N_CAMS, image_size=SIZE, num_leaves=4))
    jcfg, jparams, tcfg, tparams = bridged_smoke(N_CAMS)
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams,
                jcams=jax_cameras_from_scene(scene), tcams=cameras_from_scene(scene, "cpu"))


@pytest.fixture(scope="module")
def panels(models):
    """Each camera's panels rendered by both packages."""
    return [(jtrainer.render_camera(models["jparams"], models["jcams"], ci, models["jcfg"]),
             trainer.render_camera(models["tparams"], models["tcams"], ci, models["tcfg"]))
            for ci in range(N_CAMS)]


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.97])
def test_backproject_camera_matches_jax(models, threshold):
    rng = np.random.RandomState(1)
    depth = rng.uniform(0.2, 3.0, (SIZE, SIZE)).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (SIZE, SIZE, 3)).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (SIZE, SIZE)).astype(np.float32)
    for ci in (0, N_CAMS - 1):
        got = rgb_pointcloud.backproject_camera(models["tcams"], ci, depth, rgb, acc, threshold)
        want = jrgb.backproject_camera(models["jcams"], ci, depth, rgb, acc, threshold)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=BACKPROJECT_ATOL, rtol=0)
        assert len(got[0]) == int((acc >= threshold).sum())
        assert got[1].min() >= 0.0 and got[1].max() <= 1.0


@pytest.mark.parametrize("panel", ["rgb", "depth", "accumulation"])
def test_render_camera_panels_match_jax(panels, panel):
    for jp, tp in panels:
        want = np.asarray(jp[panel])
        assert tp[panel].shape == want.shape
        np.testing.assert_allclose(tp[panel].numpy(), want, atol=RENDER_ATOL, rtol=0)


def _gap_threshold(panels) -> float:
    """The midpoint of the widest gap between the accumulations of the
    middle half of all pixels: no pixel lies within RENDER_ATOL of it."""
    acc = np.sort(np.concatenate([np.asarray(jp["accumulation"]).ravel() for jp, _ in panels]))
    mid = acc[len(acc) // 4: 3 * len(acc) // 4]
    i = int(np.argmax(np.diff(mid)))
    assert mid[i + 1] - mid[i] > 2 * RENDER_ATOL
    return float(mid[i] + mid[i + 1]) / 2


@pytest.mark.parametrize("num_points, nb_points", [(10**6, 8), (1000, 8), (1500, 1)],
                         ids=["all", "subsampled", "uncleaned"])
def test_export_rgb_pointcloud_matches_jax(models, panels, num_points, nb_points):
    """The whole export at an accumulation threshold with no pixel within
    the render tolerance of it: the same points survive the gate, the
    seeded subsample and the outlier cleaning on both sides."""
    thr = _gap_threshold(panels)
    kw = dict(num_points=num_points, acc_threshold=thr, outlier_nb_points=nb_points,
              dataparser_scale=0.5, seed=3)
    got = rgb_pointcloud.export_rgb_pointcloud(
        models["tparams"], models["tcfg"], models["tcams"], range(N_CAMS), **kw)
    want = jrgb.export_rgb_pointcloud(
        models["jparams"], models["jcfg"], models["jcams"], range(N_CAMS), **kw)
    assert 0 < len(want[0]) <= num_points and len(got[0]) == len(want[0])
    np.testing.assert_allclose(got[0], want[0], atol=POINT_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=RENDER_ATOL, rtol=0)


def _capture_run(tmp_path, downscale: int):
    """A smoke run trained 2 steps on a 6-camera 32^2 capture with an
    images_2/ level, at ``--downscale-factor downscale``."""
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
    port_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(root), "--output-dir",
              str(run), "--max-iters", "2", "--train-rays-per-batch", "64",
              "--downscale-factor", str(downscale), "--device", "cpu"])
    return root, run


def test_export_pointcloud_cli_writes_point_cloud_ply(tmp_path, capsys, monkeypatch):
    """``export --mode pointcloud`` on a trained run writes
    ``point_cloud.ply`` with colours, subsampled to ``--num-points``; with
    ``--data synthetic`` it renders the synthetic ring's first
    ``--pointcloud-cameras`` cameras at 256^2 (its render is not repeated
    here: the cameras it is handed are checked)."""
    root, run = _capture_run(tmp_path, 1)
    out = tmp_path / "export"
    port_cli(["export", "--load-dir", str(run), "--output-dir", str(out), "--mode", "pointcloud",
              "--data", str(root), "--pointcloud-cameras", "4", "--acc-threshold", "0.0",
              "--num-points", "1500", "--device", "cpu"])
    cloud = read_ply(out / "point_cloud.ply")
    assert 0 < len(cloud["points"]) <= 1500 and np.isfinite(cloud["points"]).all()
    assert cloud["colors"].shape == (len(cloud["points"]), 3)
    assert f"point_cloud: {len(cloud['points'])} points" in capsys.readouterr().out
    seen = []
    monkeypatch.setattr(rgb_pointcloud, "export_rgb_pointcloud",
                        lambda params, config, cams, indices, **kw: seen.append(
                            (cams.num_cameras, cams.height.tolist(), cams.width.tolist(),
                             list(indices), kw["dataparser_scale"]))
                        or (np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)))
    port_cli(["export", "--load-dir", str(run), "--output-dir", str(out), "--mode", "pointcloud",
              "--data", "synthetic", "--pointcloud-cameras", "2", "--device", "cpu"])
    manifest = json.loads((run / "manifest.json").read_text())
    assert seen == [(2, [256, 256], [256, 256], [0, 1], manifest["dataparser_scale"])]
    assert len(read_ply(out / "point_cloud.ply")["points"]) == 2


def test_export_pointcloud_uses_the_trained_downscale_factor(tmp_path, monkeypatch):
    """A run trained at --downscale-factor 2 back-projects 16^2 panels of
    its 32^2 capture: the capture is parsed at the run's factor, as eval and
    render parse it."""
    root, run = _capture_run(tmp_path, 2)
    assert json.loads((run / "manifest.json").read_text())["downscale_factor"] == 2
    shapes = []
    real = rgb_pointcloud.backproject_camera
    monkeypatch.setattr(rgb_pointcloud, "backproject_camera",
                        lambda cams, ci, depth, *a: shapes.append(depth.shape)
                        or real(cams, ci, depth, *a))
    port_cli(["export", "--load-dir", str(run), "--output-dir", str(tmp_path / "export"),
              "--mode", "pointcloud", "--data", str(root), "--pointcloud-cameras", "3",
              "--acc-threshold", "0.0", "--device", "cpu"])
    assert shapes == [(16, 16)] * 3
    assert len(read_ply(tmp_path / "export" / "point_cloud.ply")["points"]) > 0
