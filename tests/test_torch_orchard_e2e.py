"""The port's CLI (``python -m fruitnerf_tpu_torch``) end to end at toy size,
each command in a fresh interpreter where importing JAX or the JAX package
fails, on the CPU through ``--device cpu``: orchard-e2e
writes its report, manifest and clouds; a rerun resumes with zero steps and
null rates; a resume with another camera elevation raises; export on the
run directory reproduces the clouds; count records the cloud it fell back
to; train writes a run that export reads; without ``--device`` a command
asks for the card and fails where there is none. Also ``get_preset``, and
that no module of the port imports the JAX package."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fruitnerf_tpu import native as jax_native
from fruitnerf_tpu_torch import __main__ as port_cli
from fruitnerf_tpu_torch import configs, native
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.export.ply import read_ply, write_ply
from fruitnerf_tpu_torch.fields.density_field import DensityFieldConfig
from fruitnerf_tpu_torch.models.fruit_model import forward_train, init_fruit_model
from fruitnerf_tpu_torch.scripts import count

REPO = Path(__file__).resolve().parents[1]
# Makes JAX, flax, optax and the JAX package unimportable.
BLOCK = """
import sys
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fruitnerf_tpu"):
            raise ImportError(f"{name} is blocked: the port runs without JAX")
sys.meta_path.insert(0, NoJax())
"""
# Runs ``python -m fruitnerf_tpu_torch <args>`` behind BLOCK.
NO_JAX = BLOCK + """
import runpy
sys.argv[0] = "fruitnerf_tpu_torch"
runpy.run_module("fruitnerf_tpu_torch", run_name="__main__", alter_sys=True)
"""
TOY = ["--num-fruits", "6", "--num-cameras", "6", "--image-size", "32", "--iters", "20",
       "--export-n", "32", "--train-rays-per-batch", "256", "--grid-levels", "4",
       "--table-size", "512", "--mid-table-size", "256", "--fine-levels", "2",
       # a dense start, so that the density cloud is not empty after 20 steps
       "--density-bias", "5", "--device", "cpu"]
# the JAX twin's report keys
REPORT_KEYS = {"args", "render_scene_s", "fruit_radius", "train_s", "train_rays_per_sec",
               "loop_timings", "train_rays_per_sec_train_only", "eval", "eval_s", "export_s",
               "export_probes_per_sec", "export_points", "count_s", "counting", "gt_count"}


def cli(*args, check=True, script=NO_JAX) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    if check:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def _clouds(d: Path) -> dict:
    return {n: read_ply(d / f"{n}.ply") for n in ("semantic", "semantic_colormap", "density")}


@pytest.fixture(scope="module")
def run(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("orchard")
    cli("orchard-e2e", *TOY, "--output-dir", out)
    return out


def test_orchard_e2e_writes_report_manifest_and_clouds(run):
    report = json.loads((run / "orchard_report.json").read_text())
    assert REPORT_KEYS <= set(report)
    assert report["gt_count"] == 6 and report["steps_run"] == 20
    assert report["device"] == "cpu"  # the device the numbers were taken on
    assert report["train_rays_per_sec"] > 0 and report["train_rays_per_sec_train_only"] > 0
    assert set(report["counting"]) == {"semantic_colormap", "semantic"}
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["variant"] == "grid" and manifest["camera_elevation"] == [0.25, 0.8]
    assert manifest["config_overrides"]["grid_levels"] == 4
    assert manifest["grid"]["rows"] == [256, 256, 512, 512]  # res 16, 81, 406, 2048
    clouds = _clouds(run)
    assert {n: len(c["points"]) for n, c in clouds.items()} == report["export_points"]
    assert report["export_points"]["density"] > 0


def test_rerun_resumes_with_zero_steps_and_null_rates(run):
    before = _clouds(run)
    proc = cli("orchard-e2e", *TOY, "--output-dir", run)
    assert "resuming from step 20" in proc.stdout
    report = json.loads((run / "orchard_report.json").read_text())
    assert report["resumed_from_step"] == 20 and report["steps_run"] == 0
    assert report["train_rays_per_sec"] is None
    assert report["train_rays_per_sec_train_only"] is None
    for name, cloud in _clouds(run).items():
        np.testing.assert_array_equal(cloud["points"], before[name]["points"], err_msg=name)


def test_resume_with_another_camera_elevation_raises(run):
    proc = cli("orchard-e2e", *TOY, "--camera-elevation", "-0.2", "0.8", "--output-dir", run,
               check=False)
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "--camera-elevation" in proc.stderr


def test_export_reproduces_the_clouds(run):
    out = run / "export"
    proc = cli("export", "--load-dir", run, "--output-dir", out, "--num-points-per-side", 32,
               "--device", "cpu")
    assert "loaded step 20" in proc.stdout
    for name, cloud in _clouds(out).items():
        np.testing.assert_array_equal(cloud["points"], _clouds(run)[name]["points"], err_msg=name)
        np.testing.assert_array_equal(cloud["colors"], _clouds(run)[name]["colors"], err_msg=name)


def test_count_records_the_cloud_used(tmp_path):
    """An empty semantic_colormap.ply falls back to semantic.ply (two fruits);
    the results name the cloud counted."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1000, 3))
    shell = 0.05 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    pts = np.concatenate([shell[:500], shell[500:] + [0.4, 0.0, 0.0]]).astype(np.float32)
    write_ply(tmp_path / "semantic_colormap.ply", np.zeros((0, 3), np.float32))
    write_ply(tmp_path / "semantic.ply", pts)
    out = tmp_path / "results.json"
    proc = cli("count", "--cloud", tmp_path / "semantic_colormap.ply", "--template-size", 1.25,
               "--eps", 0.02, "--min-samples", 8, "--remove-outliers-nb-points", 20,
               "--remove-outliers-radius", 0.02, "--down-sample", 0.004,
               "--cluster-merge-distance", 0.02, "--gt-count", 2, "--output", out)
    results = json.loads(out.read_text())
    assert results["cli"]["cloud_used"] == str(tmp_path / "semantic.ply")
    assert results["cli"]["count"] == 2
    assert json.loads(proc.stdout[proc.stdout.index("{\n"):]) == results


def test_native_library_is_the_counting_cascades():
    """The port loads its own build of the native library, and it gives the
    JAX package's library's labels."""
    if jax_native.load() is None:
        pytest.skip("g++ could not build the native counting library")
    lib = count.native_library()
    assert lib is not None and lib == native.library_path() != jax_native._SO
    pts = np.random.default_rng(4).normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.dbscan(pts, 0.2, 10), jax_native.dbscan(pts, 0.2, 10))


def test_train_cli_writes_a_run_that_export_reads(tmp_path):
    run = tmp_path / "run"
    cli("train", "--data", "synthetic", "--output-dir", run, "--max-iters", 2,
        "--train-rays-per-batch", 64, "--sparsity-loss", 0.005, "--device", "cpu")
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["config_overrides"] == {"train_rays_per_batch": 64, "sparsity_loss": 0.005}
    assert manifest["grid"]["caps"] == [4096] * 12 + [8192] * 4
    assert (run / "checkpoints" / "ckpt_000000002.pt").exists()
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert "final_eval_psnr" in records[-1]
    cli("export", "--load-dir", run, "--output-dir", tmp_path / "export",
        "--num-points-per-side", 8, "--device", "cpu")
    assert all(read_ply(tmp_path / "export" / f"{n}.ply")["points"].shape[1] == 3
               for n in ("semantic", "semantic_colormap", "density"))


@pytest.mark.parametrize("name, variant", [("fruit_nerf_big", "grid"), ("fruit_nerf_smoke", "grid"),
                                           ("fruit_nerf", "tpu"), ("fruit_nerf", "parity")])
def test_get_preset_serves_only_the_ported_preset(name, variant):
    """Every preset and variant is ported now: each builds, inits and runs
    one eval forward, its field encoded as the variant says (the smoke
    preset takes no variant and encodes with a hash grid)."""
    assert configs.get_preset("fruit_nerf", 5) == configs.fruit_nerf(5)
    kw = {} if name == "fruit_nerf_smoke" else {"variant": variant}
    cfg = configs.get_preset(name, 5, **kw)
    want = "hash" if name == "fruit_nerf_smoke" else {"grid": "grid", "tpu": "freq",
                                                       "parity": "hash"}[variant]
    assert cfg.model.field.encoding == want
    if want == "hash":
        assert all(isinstance(c, DensityFieldConfig) for c in cfg.model.proposal_nets)
    params = init_fruit_model(cfg.model, torch.Generator().manual_seed(0), "cpu")
    key = cfg.model.field.table_key
    if key is not None:
        assert params["field"][key].shape == cfg.model.field.encoding_config.table_shape
    g = torch.Generator().manual_seed(1)
    bundle = RayBundle(torch.rand((4, 3), generator=g) - 0.5, torch.nn.functional.normalize(
        torch.randn((4, 3), generator=g), dim=-1), torch.zeros(4), torch.full((4,), 2.0),
        torch.zeros(4, dtype=torch.int64))
    with torch.no_grad():
        out = forward_train(params, bundle, cfg.model, None, step=0, train=False)
    assert out["rgb"].shape == (4, 3) and bool(torch.isfinite(out["rgb"]).all())


@pytest.mark.parametrize("argv", [
    ["orchard-e2e", *[a for a in TOY if a not in ("--device", "cpu")]],
    ["train", "--data", "synthetic", "--max-iters", "2"],
    ["export", "--load-dir", "unused"],
])
def test_without_device_a_command_asks_for_the_card(argv, tmp_path):
    """With no ``--device`` a command runs on the card; where torch finds
    none it fails with a message that says so, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    out = tmp_path / "out"
    proc = cli(*argv, "--output-dir", out, check=False)
    assert proc.returncode != 0
    assert "finds no CUDA card" in proc.stderr and "--device cpu" in proc.stderr
    assert not out.exists()


@pytest.mark.parametrize("argv", [
    ["suggest-crop", "--load-dir", "{run}", "--output-dir", "{out}"],
    ["viewer", "--load-dir", "{run}", "--port", "0"],
    ["speed-probe", "--output", "{out}/probe.json"],
    ["count", "--cloud", "{out}/missing.ply"],
])
def test_the_tools_ask_for_the_card(argv, run, tmp_path):
    """``suggest-crop``, ``viewer`` and ``speed-probe`` run on the card by
    default and stop before they write anything where torch finds none;
    ``count``'s ``--device`` defaults to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    out = tmp_path / "out"
    args = [a.format(run=run, out=out) for a in argv]
    if argv[0] == "count":
        parser = argparse.ArgumentParser()
        count.add_args(parser)
        assert parser.parse_args(args[1:]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="finds no CUDA card"):
        port_cli.main(args)
    assert not out.exists()


IMPORT_ALL = BLOCK + """
import importlib, pkgutil, fruitnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fruitnerf_tpu_torch.__path__, "fruitnerf_tpu_torch.")]
tools = {"fruitnerf_tpu_torch." + m for m in (
    "utils.profiling", "export.rgb_pointcloud", "scripts.suggest_crop", "scripts.speed_probe",
    "viewer.server", "counting.dbscan_device", "parallel.mesh", "parallel.multi_scene",
    "scripts.multi_scene_campaign")}
assert tools <= set(names), sorted(tools - set(names))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "fruitnerf_tpu" or m.startswith("fruitnerf_tpu."))
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
print(len(names), loaded, jax)
assert not loaded and not jax
"""


def test_every_module_imports_without_the_jax_package():
    proc = cli(script=IMPORT_ALL)
    count_, loaded, jax = proc.stdout.split(" ", 2)
    assert int(count_) >= 40 and loaded + " " + jax.strip() == "[] []"
