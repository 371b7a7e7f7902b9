"""fruitnerf_tpu_torch.engine.trainer.train_loop on a tiny corner-mode
config on the CPU: a run split by a checkpoint and a resume into a fresh
state equals the straight run; SIGTERM checkpoints and returns early; evals
rotate through the eval cameras and every record reaches the writer. Also
``evaluate_image`` against the JAX package's on the same parameters."""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu.utils.writer import MetricWriter
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig

N_CAMS = 6
GRID = dict(num_levels=3, table_size=256, base_res=4, max_res=32, mode="corner")
OVERRIDES = {"sparsity_loss": 0.005, "sparsity_points": 32, "train_rays_per_batch": 32}
PARAM_RTOL = 1e-6  # of each parameter's max; bitwise is expected on the CPU
EVAL_ATOL = 1e-4  # eval metrics of a float32 16x16 render, port against JAX


def _shrink(cfg, grid, dtype):
    m = cfg.model
    model = dataclasses.replace(
        m, num_proposal_samples=(16, 8), num_nerf_samples=8,
        proposal_nets=tuple(dataclasses.replace(p, compute_dtype=dtype) for p in m.proposal_nets),
        field=dataclasses.replace(m.field, grid=grid, hidden_dim=16, hidden_dim_color=16,
                                  hidden_dim_semantic=16, appearance_embed_dim=4),
    )
    return dataclasses.replace(cfg, model=model)


def _config(**loop):
    cfg = configs.apply_overrides(configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32),
                                  OVERRIDES)
    return dataclasses.replace(_shrink(cfg, GridEncodingConfig(**GRID), torch.float32), **loop)


@pytest.fixture(scope="module")
def scene():
    return render_scene(SyntheticSceneConfig(image_size=16, num_cameras=N_CAMS, num_leaves=4))


@pytest.fixture(scope="module")
def data(scene):
    return dataset_from_scene(scene, "cpu", train_fraction=0.6)


def _with_max_steps(cfg, n):
    """Every group decays over n steps, whatever the run's max_iters."""
    groups = ("fields_opt", "proposal_opt", "appearance_opt", "camera_opt")
    return dataclasses.replace(cfg, **{
        g: dataclasses.replace(getattr(cfg, g), max_steps=n) for g in groups})


def test_resumed_run_equals_straight_run(data, tmp_path):
    """N steps straight against N/2 steps, a checkpoint, a resume into a
    fresh state and fresh generator, and N/2 more. The schedules decay over
    N in both (``max_steps``), and the checkpoint carries the generator."""
    n = 6
    full = _with_max_steps(_config(max_iters=n, steps_per_save=0), n)
    straight = trainer.train_loop(full, data, generator=torch.Generator().manual_seed(0))

    half = dataclasses.replace(full, max_iters=n // 2, steps_per_save=n // 2)
    first = trainer.train_loop(half, data, generator=torch.Generator().manual_seed(0),
                               checkpoint_dir=tmp_path)
    assert first.step == n // 2
    assert [p.name for p in tmp_path.iterdir()] == [f"ckpt_{n // 2:09d}.pt"]
    fresh = trainer.init_train_state(full, N_CAMS, "cpu",
                                     generator=torch.Generator().manual_seed(99))
    gen = torch.Generator().manual_seed(123)
    state, resumed = ck.resume_from_latest(tmp_path, fresh, gen)
    assert resumed and state.step == n // 2
    state = trainer.train_loop(full, data, state=state, generator=gen)
    assert state.step == straight.step == n
    for a, b in zip(bridge.tree_leaves(straight.params), bridge.tree_leaves(state.params)):
        a, b = a.detach(), b.detach()
        tol = PARAM_RTOL * max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol


def test_sigterm_checkpoints_and_returns(data, tmp_path):
    """A SIGTERM raised from a callback at step 2: the loop finishes the
    step it is in, checkpoints it and returns, and restores the handler."""
    cfg = _config(max_iters=10, steps_per_save=100)
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def terminate_at_2(step, state, metrics):
        seen.append(step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    state = trainer.train_loop(cfg, data, generator=torch.Generator().manual_seed(0),
                               checkpoint_dir=tmp_path, callbacks=(terminate_at_2,))
    assert state.step == 3 and seen == [1, 2]
    assert ck.latest_checkpoint(tmp_path).name == "ckpt_000000003.pt"
    assert signal.getsignal(signal.SIGTERM) is before


def test_eval_rotation_writer_and_timings(data, tmp_path, monkeypatch):
    cfg = _config(max_iters=7, steps_per_eval=2, steps_per_log=3, steps_per_save=4)
    held = [i for i in range(N_CAMS) if i not in set(data.train_indices.tolist())]
    assert len(held) == 2
    evaluated = []
    real = trainer.evaluate_image

    def spy(params, data, camera_index, config):
        evaluated.append(camera_index)
        return real(params, data, camera_index, config)

    monkeypatch.setattr(trainer, "evaluate_image", spy)
    writer = MetricWriter(tmp_path / "metrics.jsonl", also_print=False)
    timings = {}
    state = trainer.train_loop(cfg, data, eval_indices=np.array(held), writer=writer,
                               checkpoint_dir=tmp_path / "ckpt", timings=timings)
    writer.close()
    assert state.step == 7
    assert evaluated == [held[0], held[1], held[0]]  # at steps 2, 4 and 6
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "total_loss" in r]
    evals = [r for r in records if "eval_psnr" in r]
    assert [r["step"] for r in train] == [3, 6]
    assert {"rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "psnr"} <= set(train[0])
    assert [r["step"] for r in evals] == [2, 4, 6]
    for r in evals:
        assert {"eval_psnr", "eval_ssim", "eval_iou", "eval_iou_reference_quirk",
                "eval_num_rays_per_sec", "eval_fps"} <= set(r)
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("eval_"))
        assert -1.0 <= r["eval_ssim"] <= 1.0
    # saves at step 4 and at the end (7 is no multiple of 4)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_000000004.pt", "ckpt_000000007.pt"]
    assert set(timings) == {"train_s", "eval_s", "save_s"}
    assert all(v > 0 for v in timings.values())


def test_evaluate_image_matches_jax(scene, data):
    """Eval stats of one held-out camera on the same (bridged) parameters;
    the two renders agree to ~1e-4, so the metrics do too. ``evaluate_all``
    averages over cameras."""
    jcfg = jconfigs.apply_overrides(jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32),
                                    OVERRIDES)
    jcfg = _shrink(jcfg, JaxGrid(**GRID), jnp.float32)
    tcfg = _config()
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    params0 = jax.tree.map(np.asarray, jstate.params)
    # O(1) table entries so the render shows the grid
    params0["model"]["field"]["grid_table"] = params0["model"]["field"]["grid_table"] * 1e4
    jdata = jax_dataset_from_scene(scene, train_fraction=0.6)
    jstats, _ = jtrainer.evaluate_image(jax.tree.map(jnp.asarray, params0), jdata, 4, jcfg)
    tparams = bridge.params_from_jax(params0, tcfg.model, "cpu")
    tstats, out = trainer.evaluate_image(tparams, data, 4, tcfg)
    assert out["rgb"].shape == (16, 16, 3)
    for k in ("psnr", "ssim", "iou", "iou_reference_quirk"):
        np.testing.assert_allclose(tstats[k], jstats[k], atol=EVAL_ATOL, rtol=1e-4, err_msg=k)
    assert tstats["num_rays_per_sec"] > 0 and tstats["fps"] > 0
    both = trainer.evaluate_all(tparams, data, [4, 2], tcfg)
    other, _ = trainer.evaluate_image(tparams, data, 2, tcfg)
    np.testing.assert_allclose(both["psnr"], (tstats["psnr"] + other["psnr"]) / 2, rtol=1e-6)
