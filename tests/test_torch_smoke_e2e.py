"""The smoke preset end to end on the CPU, as tests/test_train_e2e.py runs
it on the JAX package: train the port's hash-grid FruitModel on a synthetic
fruit scene and check that the losses fall, renders have their shapes, eval
metrics are sane, fruit scores above background, checkpoints round-trip,
the manifest records the run, one seed gives one loss, and an export finds
the fruit. The port trains fewer steps (160 at 256 rays against 640 at
512): its semantic separation is 0.79 there (measured at 512 rays), far
above the JAX test's 0.015 margin."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from fruitnerf_tpu_torch.bridge import tree_leaves
from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.checkpoints import (
    grid_from_manifest, latest_checkpoint, load_checkpoint, read_manifest, resume_from_latest,
    save_checkpoint, write_manifest,
)
from fruitnerf_tpu_torch.engine.trainer import (
    draw_step, evaluate_image, init_train_state, render_camera, train_step,
)
from fruitnerf_tpu_torch.export.volume_sampler import ExportConfig, sample_volume

STEPS = 160


@pytest.fixture(scope="module")
def scene():
    return render_scene(SyntheticSceneConfig(num_fruits=5, fruit_radius=0.13, num_cameras=12,
                                             image_size=48, num_leaves=8), device="cpu")


@pytest.fixture(scope="module")
def data(scene):
    return dataset_from_scene(scene, "cpu")


@pytest.fixture(scope="module")
def config(data):
    return dataclasses.replace(fruit_nerf_smoke(data.cameras.num_cameras), train_rays_per_batch=256)


@contextlib.contextmanager
def _one_thread():
    """On the CPU the plain versions' backward (an index_put that
    accumulates) adds in parallel, in an order that varies with more than
    one thread; one thread repeats bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(config, data):
    """STEPS steps from seed 2, on one thread so that the run (and the
    export test's cloud, which depends on the seed) repeats exactly."""
    gen = torch.Generator().manual_seed(2)
    state = init_train_state(config, data.cameras.num_cameras, "cpu", generator=gen)
    first = None
    with _one_thread():
        for _ in range(STEPS):
            metrics = {k: float(v) for k, v in train_step(state, data, config, gen).items()}
            first = first or metrics
    return state, metrics, first


def test_losses_decrease(trained):
    _, last, first = trained
    assert last["rgb_loss"] < first["rgb_loss"] * 0.8
    assert last["semantics_loss"] < first["semantics_loss"]
    assert np.isfinite(last["total_loss"])
    assert last["psnr"] > first["psnr"]


def test_render_camera_outputs(trained, config, data):
    state, _, _ = trained
    out = render_camera(state.params, data.cameras, 0, config)
    h, w = data.image_shape
    assert out["rgb"].shape == (h, w, 3)
    assert out["depth"].shape == (h, w)
    assert out["semantics_colormap"].shape == (h, w, 1)
    rgb = out["rgb"].numpy()
    assert np.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1


def test_eval_metrics_reasonable(trained, config, data):
    state, _, _ = trained
    stats, _ = evaluate_image(state.params, data, 0, config)
    assert stats["psnr"] > 10.0
    assert 0.0 <= stats["iou"] <= 1.0 and 0.0 <= stats["iou_reference_quirk"] <= 1.0
    assert stats["num_rays_per_sec"] > 0


def test_semantics_learned_fruit_vs_background(trained, config, data):
    state, _, _ = trained
    out = render_camera(state.params, data.cameras, 0, config)
    sem = torch.sigmoid(out["semantics"][..., 0]).numpy()
    mask = data.masks[0].numpy().astype(bool)
    assert mask.sum() > 4
    assert sem[mask].mean() > sem[~mask].mean() + 0.015  # the JAX test's margin


def test_checkpoint_roundtrip(trained, config, data, tmp_path):
    """The restored state equals the trained one and takes the same next
    step (same draws) to the same loss."""
    state, _, _ = trained
    path = save_checkpoint(tmp_path, state)
    assert latest_checkpoint(tmp_path) == path
    template = init_train_state(config, data.cameras.num_cameras, "cpu",
                                generator=torch.Generator().manual_seed(9))
    restored = load_checkpoint(path, template)
    assert restored.step == state.step
    assert torch.equal(restored.params["model"]["field"]["hash_table"],
                       state.params["model"]["field"]["hash_table"])
    copy = init_train_state(config, data.cameras.num_cameras, "cpu",
                            generator=torch.Generator().manual_seed(9))
    copy = load_checkpoint(path, copy)
    draws = draw_step(config, data, torch.Generator().manual_seed(7))
    m1 = train_step(copy, data, config, draws=draws)
    m2 = train_step(restored, data, config, draws=draws)
    np.testing.assert_allclose(float(m1["total_loss"]), float(m2["total_loss"]), rtol=1e-5)


def test_resume_from_latest_empty_dir(tmp_path, config, data):
    template = init_train_state(config, data.cameras.num_cameras, "cpu",
                                generator=torch.Generator().manual_seed(0))
    _, resumed = resume_from_latest(tmp_path, template)
    assert not resumed


def test_manifest_roundtrip(tmp_path, config):
    write_manifest(tmp_path, preset="fruit_nerf_smoke", dataparser_transform=np.eye(4)[:3],
                   dataparser_scale=0.5, scene_aabb=np.array([[-1.0] * 3, [1.0] * 3]),
                   num_images=12, grid=config.model.field.encoding_config)
    m = read_manifest(tmp_path)
    assert m["dataparser_scale"] == 0.5 and m["preset"] == "fruit_nerf_smoke"
    assert np.asarray(m["dataparser_transform"]).shape == (3, 4)
    assert grid_from_manifest(m, expect=config.model.field.hash) == config.model.field.hash


def test_determinism_same_seed_same_loss(config, data):
    def run():
        gen = torch.Generator().manual_seed(0)
        state = init_train_state(config, data.cameras.num_cameras, "cpu", generator=gen)
        for _ in range(3):
            metrics = train_step(state, data, config, gen)
        return float(metrics["total_loss"]), tree_leaves(state.params)

    with _one_thread():
        (loss_a, params_a), (loss_b, params_b) = run(), run()
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_step_bench_on_the_cpu(config, data):
    """``scripts/step_bench.py``, whose ``two_runs`` chip_smoke.py and the
    gpu tests hold the card to: two runs on the same draws repeat bitwise on
    one thread, ``step_ms`` times steps, and its configurations are the grid
    and parity variants with the orchard's prior and the smoke preset."""
    from fruitnerf_tpu_torch.scripts import step_bench

    with _one_thread():
        r = step_bench.two_runs(config, data, seed=3, steps=2)
    assert r["bitwise"] and r["leaves_differ"] == 0 and r["loss_max_rel"] == 0.0, r
    assert min(step_bench.step_ms(config, data, seed=0, steps=1, warmup=1)) > 0.0
    cfgs = step_bench.configs(data.cameras.num_cameras)
    assert cfgs["smoke"].model.field.encoding == cfgs["parity"].model.field.encoding == "hash"
    assert cfgs["grid"].model.field.encoding == "grid"
    assert cfgs["grid"].model.density_sparsity_mult == cfgs["parity"].model.density_sparsity_mult \
        == 0.005


def test_sparsity_loss_opt_in(config, data):
    """Off on the smoke preset; when on, the term is in [0, mult] and adds
    to the total."""
    cfg = dataclasses.replace(config, model=dataclasses.replace(
        config.model, density_sparsity_mult=0.01, sparsity_num_points=256))
    gen = torch.Generator().manual_seed(0)
    metrics = train_step(init_train_state(cfg, data.cameras.num_cameras, "cpu", generator=gen),
                         data, cfg, gen)
    assert 0.0 <= float(metrics["sparsity_loss"]) <= 0.01 + 1e-6
    parts = sum(float(metrics[k]) for k in
                ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss"))
    assert abs(float(metrics["total_loss"]) - parts) < 1e-4
    gen = torch.Generator().manual_seed(0)
    m0 = train_step(init_train_state(config, data.cameras.num_cameras, "cpu", generator=gen),
                    data, config, gen)
    assert "sparsity_loss" not in m0


def test_volume_export_finds_fruit(trained, config, scene, tmp_path):
    """Most exported semantic points sit within ~2 fruit radii of a fruit."""
    state, _, _ = trained
    cfg = ExportConfig(bounding_box_min=(-0.7, -0.7, -0.7), bounding_box_max=(0.7, 0.7, 0.7),
                       num_points_per_side=48, num_rays_per_batch=48 * 48,
                       semantic_logit_threshold=-1.0, density_threshold=0.3,
                       colormap_prob_threshold=0.6)
    out = sample_volume(state.params["model"], config.model, cfg, dataparser_scale=1.0,
                        output_dir=tmp_path, progress=False)
    assert (tmp_path / "semantic.ply").exists() and (tmp_path / "density.ply").exists()
    assert out["density"]["points"].shape[0] > 0
    sem = out["semantic"]["points"]
    assert sem.shape[0] >= 20, sem.shape  # 1006 on one thread from seed 2
    d = np.linalg.norm(sem[:, None, :] - scene["fruit_centers"][None], axis=-1).min(axis=1)
    assert np.median(d) < 2.5 * scene["fruit_radius"], (sem.shape, float(np.median(d)))
