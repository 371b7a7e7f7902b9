"""What the big and huge presets add to training: ``subsample_train_images``
(the JAX package's indices), checkpoints saved asynchronously (a save asked
for at step s holds step s, though the step updates parameters and moments
in place afterwards), and a ``train_loop`` of the big preset's RAdam groups
with mid-run asynchronous saves that resumes to the uninterrupted state."""
import concurrent.futures
import dataclasses
import threading

import numpy as np
import pytest
import torch
from test_torch_train_loop import GRID, N_CAMS, OVERRIDES, PARAM_RTOL, _shrink, _with_max_steps

from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig


def _datasets(train_indices):
    n = 260
    images, masks = np.zeros((n, 2, 2, 3), np.uint8), np.zeros((n, 2, 2), np.uint8)
    port = trainer.build_device_dataset(images, masks, None, train_indices, "cpu")
    ref = jtrainer.build_device_dataset(images, masks, None, train_indices)
    return port, ref


@pytest.mark.parametrize("kept", [200, 250, 300])
def test_subsample_keeps_the_jax_indices(kept):
    """250 train images (every image but a few held out) cut to ``kept``."""
    idx = np.array([i for i in range(260) if i % 26 != 5])
    assert len(idx) == 250
    port, ref = _datasets(idx)
    got = trainer.subsample_train_images(port, kept).train_indices.numpy()
    want = np.asarray(jtrainer.subsample_train_images(ref, kept).train_indices)
    np.testing.assert_array_equal(got, want)
    assert len(got) == min(kept, 250) and np.all(np.diff(got) > 0)


def _config(preset, **loop):
    cfg = configs.apply_overrides(
        configs.get_preset(preset, N_CAMS, compute_dtype=torch.float32), OVERRIDES)
    return dataclasses.replace(_shrink(cfg, GridEncodingConfig(**GRID), torch.float32), **loop)


@pytest.fixture(scope="module")
def data():
    scene = render_scene(SyntheticSceneConfig(image_size=16, num_cameras=N_CAMS, num_leaves=4),
                         device="cpu")
    return dataset_from_scene(scene, "cpu", train_fraction=0.6)


def test_async_save_holds_the_step_it_was_asked_at(data, tmp_path):
    """The writer is held back until two more in-place steps have run: the
    checkpoint still holds the parameters, the RAdam moments, the step and
    the generator of the step it was asked at."""
    cfg = _config("fruit_nerf_big", max_iters=10)
    gen = torch.Generator().manual_seed(0)
    state = trainer.init_train_state(cfg, N_CAMS, "cpu", generator=gen)
    for _ in range(3):
        trainer.train_step(state, data, cfg, gen)
    want_params = [t.detach().clone() for t in bridge.tree_leaves(state.params)]
    want_moments = {i: st["exp_avg"].clone()
                    for i, st in enumerate(state.optimizer.parts["radam"].state.values())}
    want_gen = gen.get_state()
    gate = threading.Event()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pool.submit(gate.wait)  # the writer starts only once the gate opens
        fut = ck.save_checkpoint_async(tmp_path, state, gen, pool)
        for _ in range(2):
            trainer.train_step(state, data, cfg, gen)
        assert not fut.done()
        gate.set()
        path = fut.result(timeout=60)
    assert path.name == "ckpt_000000003.pt" and state.step == 5
    fresh_gen = torch.Generator()
    restored = ck.load_checkpoint(path, trainer.init_train_state(cfg, N_CAMS, "cpu"), fresh_gen)
    assert restored.step == 3
    for a, b in zip(want_params, bridge.tree_leaves(restored.params)):
        assert torch.equal(a, b.detach())
    moments = list(restored.optimizer.parts["radam"].state.values())
    assert all(torch.equal(want_moments[i], moments[i]["exp_avg"]) for i in want_moments)
    assert torch.equal(fresh_gen.get_state(), want_gen)


def test_train_loop_with_async_saves_resumes_to_the_straight_run(data, tmp_path):
    """The big preset's groups (RAdam fields and proposals, Adam appearance
    and camera) over 8 steps, saved at 4 and 8 by the writer thread: a
    resume from step 4 into a fresh state and generator ends on the
    straight run's parameters, the RAdam switch (step 6) on the way
    (PARAM_RTOL: bitwise on one CPU thread, as in test_torch_train_loop.py)."""
    n = 8
    full = _with_max_steps(_config("fruit_nerf_big", max_iters=n, steps_per_save=n // 2), n)
    straight = trainer.train_loop(full, data, generator=torch.Generator().manual_seed(0),
                                  checkpoint_dir=tmp_path / "straight")
    assert sorted(p.name for p in (tmp_path / "straight").iterdir()) == \
        ["ckpt_000000004.pt", "ckpt_000000008.pt"]
    fresh = trainer.init_train_state(full, N_CAMS, "cpu",
                                     generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(123)
    state = ck.load_checkpoint(tmp_path / "straight" / "ckpt_000000004.pt", fresh, gen)
    state = trainer.train_loop(full, data, state=state, generator=gen)
    assert state.step == straight.step == n
    for a, b in zip(bridge.tree_leaves(straight.params), bridge.tree_leaves(state.params)):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= PARAM_RTOL * max(float(a.abs().max()), 1e-30)
    final = ck.load_checkpoint(tmp_path / "straight" / "ckpt_000000008.pt",
                               trainer.init_train_state(full, N_CAMS, "cpu"))
    for a, b in zip(bridge.tree_leaves(straight.params), bridge.tree_leaves(final.params)):
        assert torch.equal(a.detach(), b.detach())


def test_a_failed_write_surfaces(data, tmp_path):
    """A checkpoint directory that cannot be written fails the loop at its
    end, where the writes are waited for, not silently."""
    cfg = _config("fruit_nerf_big", max_iters=2, steps_per_save=1)
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    with pytest.raises(OSError):
        trainer.train_loop(cfg, data, generator=torch.Generator().manual_seed(0),
                           checkpoint_dir=blocked)
