"""What the port's ``orchard-e2e`` feeds its trainer, against the JAX
package's ``orchard-e2e`` on the same small orchard: the dataset's pixels and
mask targets, the cameras, the train and eval indices at the 0.95 split,
the config, and the manifest's transform, scale and box. Also that a
capture of the scene gives ``train --data`` the same mask targets, the
learning rates of ``scripts/convergence.py``'s runs, and ``chip_smoke.py``'s
count criterion on a planted cloud."""
import argparse
import dataclasses
import json

import numpy as np
import pytest
from test_torch_bridge import _shared_fields

import chip_smoke
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.scripts import orchard_e2e as jax_e2e
from fruitnerf_tpu_torch import configs
from fruitnerf_tpu_torch.data.builder import dataset_from_parsed, dataset_from_scene
from fruitnerf_tpu_torch.data.dataparser import DataParserConfig, parse_transforms
from fruitnerf_tpu_torch.data.fixture import write_scene_capture
from fruitnerf_tpu_torch.data.synthetic import orchard_config, render_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.scripts import convergence, orchard_e2e

ARGS = ["--num-fruits", "8", "--num-cameras", "40", "--image-size", "32", "--iters", "30",
        "--sparsity-loss", "0.005", "--train-rays-per-batch", "256"]


class Fed(Exception):
    """Raised by the spies once the trainer has been fed."""


def _fed(module, e2e, argv, monkeypatch, stop) -> dict:
    """Run ``e2e.main`` with ``module.train_loop`` and ``module.evaluate_all``
    replaced by spies; returns the trainer's arguments."""
    got = {}

    def train_loop(config, data, eval_indices=None, state=None, **kw):
        got.update(config=config, data=data, eval_indices=np.asarray(eval_indices))
        if stop == "train_loop":
            raise Fed
        return type("Done", (), {"step": config.max_iters, "params": None})()

    def evaluate_all(*a, **kw):
        raise Fed

    monkeypatch.setattr(module, "train_loop", train_loop)
    monkeypatch.setattr(module, "evaluate_all", evaluate_all)
    p = argparse.ArgumentParser()
    e2e.add_args(p)
    with pytest.raises(Fed):
        e2e.main(p.parse_args(argv))
    return got


def test_orchard_e2e_feeds_the_trainer_what_jax_feeds_it(tmp_path, monkeypatch):
    """Both packages render the orchard with their numpy tracers. The port
    writes its manifest before training and the JAX package after it, so
    the JAX spy returns a finished state and stops at the evaluation."""
    port = _fed(trainer, orchard_e2e, [*ARGS, "--device", "cpu", "--output-dir",
                                       str(tmp_path / "port")], monkeypatch, "train_loop")
    ref = _fed(jtrainer, jax_e2e, [*ARGS, "--output-dir", str(tmp_path / "jax")], monkeypatch,
               "evaluate_all")
    pd, jd = port["data"], ref["data"]
    np.testing.assert_array_equal(pd.images.numpy(), np.asarray(jd.images))
    np.testing.assert_array_equal(pd.masks.numpy(), np.asarray(jd.masks))
    assert 0 < pd.masks.float().mean() < 0.5 and set(np.unique(pd.masks.numpy())) == {0, 1}
    np.testing.assert_array_equal(pd.train_indices.numpy(), np.asarray(jd.train_indices))
    assert len(pd.train_indices) == 38  # ceil(0.95 * 40)
    np.testing.assert_array_equal(port["eval_indices"], ref["eval_indices"])
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(getattr(pd.cameras, k).numpy(),
                                      np.asarray(getattr(jd.cameras, k)), err_msg=k)
    _shared_fields(ref["config"], port["config"])
    assert port["config"].max_iters == ref["config"].max_iters == 30
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("port", "jax")]
    for k in ("dataparser_transform", "dataparser_scale", "scene_aabb", "num_images", "variant",
              "config_overrides"):
        assert manifests[0][k] == manifests[1][k], k
    assert manifests[0]["dataparser_transform"] == np.eye(4)[:3].tolist()
    assert manifests[0]["scene_aabb"] == [[-1.0] * 3, [1.0] * 3]


def test_a_capture_of_the_orchard_gives_the_same_mask_targets(tmp_path):
    """``train --data`` reads masks written as PNG and binarised at > 125;
    the renderer's masks are already 0/1, so the BCE targets are the ones
    ``orchard-e2e`` trains on, pixel for pixel."""
    scene = render_scene(orchard_config(num_fruits=8, num_cameras=6, image_size=32), "cpu")
    write_scene_capture(scene, tmp_path, eval_fraction=0.1)
    parsed = dataset_from_parsed(parse_transforms(DataParserConfig(data_dir=tmp_path)), "cpu")
    direct = dataset_from_scene(scene, "cpu")
    assert direct.masks.any()
    np.testing.assert_array_equal(parsed.masks.numpy(), direct.masks.numpy())
    np.testing.assert_array_equal(parsed.images.numpy(), direct.images.numpy())


@pytest.mark.parametrize("schedule", [30000, 0])
def test_a_short_run_takes_the_learning_rates_of_the_long_runs_start(schedule):
    """``with_seed_and_schedule(config, seed, 30000)`` on a 2500-step run
    gives every group the rate a 30k run has at the same step (what
    ``chip_smoke.py``'s orchard phase trains with); 0 keeps the run's own
    decay over its ``max_iters``."""
    short = dataclasses.replace(configs.fruit_nerf(8), max_iters=2500)
    got = convergence.with_seed_and_schedule(short, 43, schedule)
    want = dataclasses.replace(short, max_iters=schedule or 2500)
    assert got.seed == 43 and got.max_iters == 2500
    for group in ("fields_opt", "appearance_opt", "proposal_opt", "camera_opt"):
        for step in (0, 1000, 2499):
            assert trainer.learning_rate(getattr(got, group), step, got.max_iters) == \
                pytest.approx(trainer.learning_rate(getattr(want, group), step, want.max_iters),
                              rel=1e-12), (group, step)


def _planted(rng, radius):
    """20 GT centres 10 radii apart, 40 points on each fruit's surface."""
    centers = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)[:20]
    centers = centers * 10.0 * radius
    d = rng.standard_normal((20, 40, 3))
    pts = centers[:, None] + radius * d / np.linalg.norm(d, axis=-1, keepdims=True)
    return centers, pts.reshape(-1, 3)


@pytest.mark.parametrize("case", ["planted", "shifted", "empty", "none_counted", "over_split"])
def test_count_criterion(case):
    """The planted cloud passes; shifted by 3 fruit radii it fails on its
    share near a GT centre; an empty cloud and a count outside [1, 3 x GT]
    fail too."""
    radius = 0.04
    centers, pts = _planted(np.random.default_rng(0), radius)
    count = {"none_counted": 0, "over_split": 61}.get(case, 20)
    if case == "shifted":
        pts = pts + np.array([3.0 * radius, 0.0, 0.0])
    if case == "empty":
        pts = pts[:0]
    near, fails = chip_smoke.count_criterion(pts, count, centers, radius)
    if case == "planted":
        assert near == 1.0 and fails == []
        return
    assert len(fails) == 1, fails
    want = {"shifted": "within 2 fruit radii", "empty": "empty",
            "none_counted": "outside [1, 3 x GT]", "over_split": "outside [1, 3 x GT]"}[case]
    assert want in fails[0]
    if case == "shifted":
        assert near < 0.5
