"""The port's ``speed-probe`` (``scripts/speed_probe.py``): its candidates
are the JAX twin's, each builds through the port's ``apply_overrides``
into the config the JAX package builds (field for field) and initialises
a model of its layout; and the CLI, on the CPU at the smallest repeat
counts, prints and writes one row a candidate with the twin's keys, named
by its device."""
import dataclasses
import json

import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.scripts import speed_probe as jprobe
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.models.fruit_model import init_fruit_model
from fruitnerf_tpu_torch.scripts import speed_probe
from test_torch_bridge import _shared_fields

ROW_KEYS = {"name", "overrides", "ms_per_step", "ms_per_step_min", "ms_per_step_all",
            "rays_per_sec", "rays_per_sec_max", "vs_baseline"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: with six test workers on the
    host, torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_candidates_are_the_jax_packages():
    assert speed_probe.candidates() == jprobe.candidates()
    assert speed_probe.BASELINE_RAYS_PER_SEC == jprobe.BASELINE_RAYS_PER_SEC


@pytest.mark.parametrize("name, overrides", speed_probe.candidates())
def test_every_candidate_builds(name, overrides):
    cfg = speed_probe.candidate_config(24, overrides)
    jcfg = jconfigs.apply_overrides(dataclasses.replace(
        jconfigs.fruit_nerf(num_images=24, variant="grid"), train_rays_per_batch=4096), overrides)
    assert cfg.train_rays_per_batch == jcfg.train_rays_per_batch == 4096
    _shared_fields(jcfg, cfg)
    grid = cfg.model.field.grid
    assert list(grid.level_layout()) == list(jcfg.model.field.grid.level_layout())
    params = init_fruit_model(cfg.model, torch.Generator().manual_seed(0), "cpu")
    assert params["field"]["grid_table"].shape[0] == grid.cell_layout().total_rows


def test_cli_prints_and_writes_a_row_a_candidate(tmp_path, capsys, monkeypatch):
    """At 64 rays a step (the candidates' 4096 take seconds a step on one
    CPU thread), the CLI times the candidate and writes its row."""
    real = speed_probe.candidate_config
    monkeypatch.setattr(speed_probe, "candidate_config", lambda n, ov: dataclasses.replace(
        real(n, ov), train_rays_per_batch=64))
    out = tmp_path / "probe.json"
    port_cli(["speed-probe", "--only", "s40", "--chunk", "1", "--reps", "1",
              "--repeats", "2", "--device", "cpu", "--output", str(out)])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    (row,) = json.loads(out.read_text())
    assert printed == [row]
    assert ROW_KEYS <= set(row) and row["device"] == row["card"] == "cpu"
    assert row["name"] == "s40" and row["overrides"] == {"nerf_samples": 40}
    assert len(row["ms_per_step_all"]) == 2 and row["ms_per_step_min"] <= row["ms_per_step"]
    assert row["rays_per_sec"] == pytest.approx(64 / (row["ms_per_step"] * 1e-3))
    assert row["vs_baseline"] == pytest.approx(row["rays_per_sec"] / (30_000 * 4096 / 900))
