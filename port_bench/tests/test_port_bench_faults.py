"""A whole run, with the harness's look for a card skipped, on the CPU at a
shrunk size: sound, it is correct; with the timed path broken underneath
it is not."""
from __future__ import annotations

import dataclasses

import pytest

from port_bench import run

from . import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, seed=4_000_000_007):
    return run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                     "--trace", "0"], device="cpu", root=root, cfg_check=False)


def _unchanged(monkeypatch):
    """Every step counts itself and leaves the parameters as they were."""
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.parallel import multi_scene

    def step(state, config):
        state.step += 1

    monkeypatch.setattr(trainer, "optimizer_step", step)
    monkeypatch.setattr(multi_scene, "optimizer_step", step)


def _half_batch(monkeypatch):
    """Each step trains on the first half of its rays, the mean over them."""
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.parallel import multi_scene

    loss = trainer.compute_loss

    def half(state, data, config, draws):
        h = draws.slot.shape[-1] // 2
        cut = dataclasses.replace(
            draws, slot=draws.slot[..., :h], py=draws.py[..., :h], px=draws.px[..., :h],
            jitter=draws.jitter[..., :h], sampler=[u[..., :h, :] for u in draws.sampler])
        return loss(state, data, dataclasses.replace(
            config, train_rays_per_batch=config.train_rays_per_batch // 2), cut)

    monkeypatch.setattr(trainer, "compute_loss", half)
    monkeypatch.setattr(multi_scene, "compute_loss", half)


@pytest.mark.parametrize("workload", tiny.workloads())
def test_sound_run_is_correct(root, workload):
    out = _run(root, workload)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", tiny.workloads())
def test_broken_step_is_not_correct(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(root, workload)["correct"]
