"""The port's ``suggest-crop`` (``scripts/suggest_crop.py``) against the
JAX package's, on the CPU: ``occupied_aabb`` on tests/test_suggest_crop.py's
cases; ``occupancy_grids`` of the smoke preset's parameters made by JAX and
bridged into the port, at thresholds set at quantiles of the field itself
so that neither grid is empty; and the CLI's JSON and projections on a run
trained with shape-changing overrides, which it restores through
``engine/runs.py:load_run`` (the JAX command builds the bare preset, so
such a run cannot be restored there)."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from fruitnerf_tpu.scripts import suggest_crop as jcrop
from fruitnerf_tpu_torch.__main__ import main as port_cli
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.engine.runs import load_run
from fruitnerf_tpu_torch.models.fruit_model import forward_export
from fruitnerf_tpu_torch.scripts import suggest_crop
from test_torch_rgb_pointcloud import bridged_smoke

N = 16  # probe grid side
# A cell may differ between the two packages only where its value lies
# within this (relative to the threshold, at least 1 absolute) of the
# threshold: float32 forwards of one set of parameters by two libraries.
FLIP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: with six test workers on the
    host, torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _occ(shape, *cells):
    occ = np.zeros(shape, bool)
    for c in cells:
        occ[c] = True
    return occ


@pytest.mark.parametrize("occ, pad", [
    (_occ((16, 16, 16), np.s_[4:8, 6:10, 2:5]), 0),
    (_occ((8, 8, 8), (0, 7, 3)), 3),
    (np.zeros((4, 4, 4), bool), 1),
    (_occ((8, 8, 8), (1, 1, 1), (6, 2, 5)), 1),
], ids=["basic", "padding_clamps", "empty", "two_cells"])
def test_occupied_aabb_matches_jax(occ, pad):
    got, want = suggest_crop.occupied_aabb(occ, pad), jcrop.occupied_aabb(occ, pad)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got, want)
    assert (-1.0 <= got).all() and (got <= 1.0).all() and (got[0] < got[1]).all()


def _field_values(params, model_config, n):
    """Density and semantic logit at each probe of the grid, [n*n, n]."""
    lin = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    xs, ys = np.meshgrid(lin, lin, indexing="ij")
    origins = torch.tensor(np.stack([xs.ravel(), ys.ravel(), np.full(n * n, -1.0)], -1),
                           dtype=torch.float32)
    r = n * n
    bundle = RayBundle(origins, torch.tensor([0.0, 0.0, 1.0]).expand(r, 3), torch.zeros(r),
                       torch.full((r,), 2.0), torch.zeros(r, dtype=torch.int64))
    with torch.no_grad():
        out = forward_export(params, bundle, model_config, n,
                             torch.tensor([[-1.0] * 3, [1.0] * 3]))
    return out["density"].numpy(), out["semantics"].numpy()


@pytest.mark.parametrize("quantiles", [(0.5, 0.5), (0.9, 0.2), (0.3, 0.95)])
def test_occupancy_grids_match_jax(quantiles):
    jcfg, jparams, tcfg, tparams = bridged_smoke(4, seed=1)
    density, logit = _field_values(tparams["model"], tcfg.model, N)
    d_thr = float(np.quantile(density, quantiles[0]))
    l_thr = float(np.quantile(logit, quantiles[1]))
    got = suggest_crop.occupancy_grids(tparams["model"], tcfg.model, N, d_thr, l_thr,
                                       rays_per_batch=100)
    want = jcrop.occupancy_grids(jparams["model"], jcfg.model, N, d_thr, l_thr,
                                 rays_per_batch=100)
    near_d = np.abs(density - d_thr) <= FLIP_TOL * max(1.0, abs(d_thr))
    near_l = np.abs(logit - l_thr) <= FLIP_TOL * max(1.0, abs(l_thr))
    for g, w, near in zip(got, want, (near_d, near_d | near_l)):
        assert g.shape == w.shape == (N, N, N) and g.dtype == w.dtype == bool
        assert g.any() and not g.all()
        assert not (g != w)[~near.reshape(N, N, N)].any()
    assert (got[1] <= got[0]).all()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A grid run through orchard-e2e with shape-changing overrides (a
    4-level table of 512 rows, mid levels 256): 2 steps from a dense start."""
    from test_torch_orchard_e2e import TOY

    out = tmp_path_factory.mktemp("run")
    port_cli(["orchard-e2e", *TOY, "--iters", "2", "--output-dir", str(out)])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["config_overrides"]["mid_table_size"] == 256
    assert manifest["config_overrides"]["grid_levels"] == 4
    return out


def test_cli_restores_an_overridden_run_and_writes_json_and_projections(run, tmp_path, capsys):
    """The run restores with its overrides applied and probes; the printed
    and written JSON hold the grids' cell counts and AABBs (those of
    ``occupancy_grids`` and ``occupied_aabb`` on the restored state), and
    three 512^2 projections are written."""
    _, config, state = load_run(run, "cpu")
    density, logit = _field_values(state.params["model"], config.model, N)
    d_thr, l_thr = float(np.quantile(density, 0.8)), float(np.quantile(logit, 0.5))
    out = tmp_path / "crop"
    report = suggest_crop.main(_args(run, out, d_thr, l_thr))
    printed = capsys.readouterr().out
    assert json.loads((out / "crop_suggestion.json").read_text()) == report
    assert json.dumps(report, indent=2) in printed and "--bounding-box-min" in printed
    occ_d, occ_s = suggest_crop.occupancy_grids(state.params["model"], config.model, N, d_thr,
                                                l_thr)
    assert report["grid"] == N
    assert report["density_cells"] == int(occ_d.sum()) > 0
    assert report["semantic_cells"] == int(occ_s.sum())
    assert report["density_aabb"] == suggest_crop.occupied_aabb(occ_d, 2).round(4).tolist()
    assert [p.rsplit("/", 1)[-1] for p in report["projections"]] == [
        "crop_yz.png", "crop_xz.png", "crop_xy.png"]
    for p in report["projections"]:
        img = Image.open(p)
        assert (img.mode, img.size) == ("RGB", (512, 512))


def _args(run, out, d_thr, l_thr):
    import argparse

    p = argparse.ArgumentParser()
    suggest_crop.add_args(p)
    return p.parse_args(["--load-dir", str(run), "--output-dir", str(out), "--grid", str(N),
                         "--density-threshold", str(d_thr),
                         "--semantic-logit-threshold", str(l_thr), "--device", "cpu"])


def test_cli_with_nothing_occupied_says_so(run, tmp_path, capsys):
    port_cli(["suggest-crop", "--load-dir", str(run), "--output-dir", str(tmp_path),
              "--grid", "8", "--density-threshold", "1e30", "--device", "cpu"])
    report = json.loads((tmp_path / "crop_suggestion.json").read_text())
    assert report["density_cells"] == report["semantic_cells"] == 0
    assert report["density_aabb"] is None and report["semantic_aabb"] is None
    assert "no occupied cells found" in capsys.readouterr().out
