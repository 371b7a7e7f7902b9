"""``--mesh`` of ``eval``, ``render``, ``export`` and ``viewer`` on the CPU,
one parametrised test over the four: the sharded function
(``render_camera``/``evaluate_all``/``ViewerSession`` with ``devices``, or
``sample_volume`` with ``devices``) on two CPU shards equals the unsharded
one, and the command run through the CLI with ``--mesh --device cpu`` (a
one-shard mesh: ``--mesh`` means every visible card, and ``--device cpu``
names the CPU alone) equals the command without it. The JAX package's
counterparts are tests/test_train_e2e.py:285-324 (its sharded render and
export against the single-device ones on 8 virtual devices).

The run is a port smoke run of two steps on a capture of a 3-fruit scene at
32^2, its hash tables then redrawn in +-0.1 so that renders are not flat."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from fruitnerf_tpu_torch import __main__ as port_cli
from fruitnerf_tpu_torch.data.builder import cameras_from_parsed, dataset_from_parsed
from fruitnerf_tpu_torch.data.fixture import write_scene_capture
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.checkpoints import save_checkpoint
from fruitnerf_tpu_torch.engine.runs import load_run, parse_capture
from fruitnerf_tpu_torch.engine.trainer import evaluate_all, render_camera
from fruitnerf_tpu_torch.export.ply import read_ply
from fruitnerf_tpu_torch.export.volume_sampler import ExportConfig, sample_volume
from fruitnerf_tpu_torch.viewer import server as viewer_server

TWO = ["cpu", "cpu"]
# the sharded render against the unsharded: per-ray float32 math in chunks
# cut at other rays, whose matmuls may round apart on the CPU (observed:
# bitwise)
RENDER_ATOL = 2e-6
# eval metrics are means of those renders (timing keys excluded)
TIMING = ("num_rays_per_sec", "fps")
# a probe grid of 40^3: 1600 rays, two batches at 1024 rays a batch (the
# second partial), each cut into two shards
EXPORT = dict(num_points_per_side=40, num_rays_per_batch=1024, semantic_logit_threshold=-1e9,
              density_threshold=-1.0, colormap_prob_threshold=0.0)
EXPORT_FLAGS = ["--num-points-per-side", "40", "--num-rays-per-batch", "1024",
                "--semantic-logit-threshold=-1e9", "--density-threshold=-1",
                "--colormap-prob-threshold", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=8, image_size=32,
                                              num_leaves=4), device="cpu")
    capture = write_scene_capture(scene, root / "capture")
    run_dir = root / "run"
    port_cli.main(["train", "--preset", "fruit_nerf_smoke", "--data", str(capture),
                   "--output-dir", str(run_dir), "--max-iters", "2",
                   "--train-rays-per-batch", "128", "--device", "cpu"])
    manifest, config, state = load_run(run_dir, "cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for net in (state.params["model"]["field"], *state.params["model"]["proposal_networks"]):
            net["hash_table"].uniform_(-0.1, 0.1, generator=g)
    save_checkpoint(run_dir / "checkpoints", state)  # over the last one
    return dict(capture=capture, run=run_dir, manifest=manifest, config=config, state=state)


def _sorted(points: np.ndarray, colors: np.ndarray):
    order = np.lexsort(points.T[::-1])
    return points[order], colors[order]


def _same_cloud(a: dict, b: dict):
    (pa, ca), (pb, cb) = _sorted(a["points"], a["colors"]), _sorted(b["points"], b["colors"])
    assert pa.shape[0] > 0
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_allclose(ca, cb, atol=RENDER_ATOL, rtol=0)


def _eval(run, tmp_path):
    data = dataset_from_parsed(parse_capture(run["capture"], run["manifest"]), "cpu")
    idx = list(range(data.cameras.num_cameras))[:3]
    one, two = (evaluate_all(run["state"].params, data, idx, run["config"], devices=d)
                for d in (None, TWO))
    for k in one:
        if k not in TIMING:
            np.testing.assert_allclose(two[k], one[k], rtol=1e-6, atol=0, err_msg=k)
    outs = []
    for mesh in ([], ["--mesh"]):
        out = tmp_path / f"eval{len(mesh)}.json"
        port_cli.main(["eval", "--load-dir", str(run["run"]), "--data", str(run["capture"]),
                       "--split", "all", "--output", str(out), "--device", "cpu", *mesh])
        outs.append(json.loads(out.read_text()))
    assert {k: v for k, v in outs[0].items() if k not in TIMING} == \
        {k: v for k, v in outs[1].items() if k not in TIMING}


def _render(run, tmp_path):
    cams = cameras_from_parsed(parse_capture(run["capture"], run["manifest"]), "cpu")
    for ci in (0, 5):
        one, two = (render_camera(run["state"].params, cams, ci, run["config"], devices=d)
                    for d in (None, TWO))
        for k in one:
            torch.testing.assert_close(two[k], one[k], atol=RENDER_ATOL, rtol=0)
    pngs = []
    for mesh in ([], ["--mesh"]):
        out = tmp_path / f"render{len(mesh)}"
        port_cli.main(["render", "--load-dir", str(run["run"]), "--data", str(run["capture"]),
                       "--output-dir", str(out), "--cameras", "0", "5", "--device", "cpu",
                       *mesh])
        pngs.append([np.asarray(Image.open(p)) for p in sorted(out.glob("*.png"))])
    assert len(pngs[0]) == 10
    for a, b in zip(*pngs):
        np.testing.assert_array_equal(a, b)


def _export(run, tmp_path):
    one, two = (sample_volume(run["state"].params["model"], run["config"].model,
                              ExportConfig(**EXPORT), dataparser_scale=1.0,
                              output_dir=tmp_path / f"fn{len(d or ())}", progress=False,
                              devices=d)
                for d in (None, TWO))
    for name in one:
        _same_cloud(one[name], two[name])
    for mesh in ([], ["--mesh"]):
        port_cli.main(["export", "--load-dir", str(run["run"]), "--output-dir",
                       str(tmp_path / f"cli{len(mesh)}"), *EXPORT_FLAGS, "--device", "cpu",
                       *mesh])
    for name in ("semantic", "semantic_colormap", "density"):
        _same_cloud(*(read_ply(tmp_path / f"cli{m}" / f"{name}.ply") for m in (0, 1)))


def _viewer(run, tmp_path, monkeypatch):
    params, config = run["state"].params, run["config"]
    one, two = (viewer_server.ViewerSession(params, config, devices=d) for d in (None, TWO))
    for panel in ("rgb", "semantics", "depth", "accumulation"):
        a = one.render_frame(0.8, 0.5, 2.5, 40, panel)
        b = two.render_frame(0.8, 0.5, 2.5, 40, panel)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, panel  # a u8 level
    sessions = []

    class Served:  # stands in for the HTTP server: records the session
        def __init__(self, session):
            sessions.append(session)

        def shutdown(self):
            pass

    class Interrupt:  # ends the command's wait as ctrl-c would
        def wait(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(viewer_server, "serve", lambda s, port, host: Served(s))
    monkeypatch.setattr(viewer_server.threading, "Event", Interrupt)
    for mesh in ([], ["--mesh"]):
        port_cli.main(["viewer", "--load-dir", str(run["run"]), "--port", "0", "--device",
                       "cpu", *mesh])
    assert sessions[0].devices is None and sessions[1].devices == [torch.device("cpu")]
    for panel in ("rgb", "depth"):
        np.testing.assert_array_equal(sessions[0].render_frame(0.3, 0.6, 2.5, 40, panel),
                                      sessions[1].render_frame(0.3, 0.6, 2.5, 40, panel))


@pytest.mark.parametrize("command", ["eval", "render", "export", "viewer"])
def test_mesh_equals_the_unsharded_command(command, run, tmp_path, monkeypatch):
    if command == "viewer":
        _viewer(run, tmp_path, monkeypatch)
    else:
        {"eval": _eval, "render": _render, "export": _export}[command](run, tmp_path)
