"""The hash-grid runs through the port's entry points, on the CPU: ``train
--preset fruit_nerf_smoke`` writes a run (its manifest records the hash
encoding) that ``export`` rebuilds and reads; ``orchard-e2e --variant
parity`` at toy size (the parity variant's full tables, few rays) trains,
exports and counts; grid overrides on a hash run raise. Also the manifest's
hash entry (it round-trips and refuses a mismatch of either kind), and a
JAX smoke ``ckpt_*.msgpack`` read through ``read_jax_checkpoint``. The CLI
runs in a fresh interpreter where JAX and the JAX package cannot be
imported (tests/test_torch_orchard_e2e.py's ``cli``)."""
import dataclasses
import json

import flax.serialization
import jax
import numpy as np
import pytest
import torch
from test_torch_orchard_e2e import cli

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.engine.trainer import init_train_state as jax_init_train_state
from fruitnerf_tpu_torch import __main__ as port_cli
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.export.ply import read_ply
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig, HashEncodingConfig

CLOUDS = ("semantic", "semantic_colormap", "density")


def test_smoke_train_cli_writes_a_run_that_export_reads(tmp_path):
    run = tmp_path / "run"
    cli("train", "--preset", "fruit_nerf_smoke", "--data", "synthetic", "--output-dir", run,
        "--max-iters", 3, "--device", "cpu")
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["preset"] == "fruit_nerf_smoke" and "grid" not in manifest
    smoke = configs.fruit_nerf_smoke(24).model.field.hash
    assert manifest["hash"]["table_shape"] == list(smoke.table_shape) == [8 * 8192, 2]
    assert manifest["hash"]["resolutions"] == smoke.level_resolutions()
    assert (run / "checkpoints" / "ckpt_000000003.pt").exists()
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(records[-1]["final_eval_psnr"])
    proc = cli("export", "--load-dir", run, "--output-dir", tmp_path / "export",
               "--num-points-per-side", 8, "--device", "cpu")
    assert "loaded step 3" in proc.stdout
    assert all(read_ply(tmp_path / "export" / f"{n}.ply")["points"].shape[1] == 3 for n in CLOUDS)


PARITY_TOY = ["--num-fruits", "4", "--num-cameras", "6", "--image-size", "24", "--iters", "4",
              "--export-n", "16", "--train-rays-per-batch", "32", "--density-bias", "5",
              "--variant", "parity", "--device", "cpu"]


def test_parity_orchard_e2e_at_toy_size(tmp_path):
    """The parity variant keeps its tables (a 16-level 2^19-entry main field,
    two 5-level 2^17-entry proposal fields) and its samples; only the rays,
    steps and the scene are cut. The report's keys are the grid variant's."""
    cli("orchard-e2e", *PARITY_TOY, "--output-dir", tmp_path)
    report = json.loads((tmp_path / "orchard_report.json").read_text())
    assert report["steps_run"] == 4 and report["device"] == "cpu"
    assert np.isfinite(report["eval"]["psnr"]) and set(report["counting"]) == {
        "semantic_colormap", "semantic"}
    assert report["export_points"]["density"] > 0
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["variant"] == "parity" and "grid" not in manifest
    assert manifest["hash"]["table_shape"] == [16 * 2**19, 2]
    assert manifest["hash"]["direct"] == [True] * 5 + [False] * 11
    proc = cli("orchard-e2e", *PARITY_TOY, "--output-dir", tmp_path)  # resumes: zero steps
    assert "resuming from step 4" in proc.stdout


@pytest.mark.parametrize("flag", ["--table-size", "--grid-levels"])
def test_grid_overrides_on_a_hash_run_raise(tmp_path, flag):
    """A grid-table override names the grid variant's table; on a hash run it
    raises before the run writes anything."""
    argv = ["orchard-e2e", *PARITY_TOY, flag, "512" if flag == "--table-size" else "4",
            "--output-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="grid overrides"):
        port_cli.main(argv)
    assert not (tmp_path / "manifest.json").exists()


SMOKE_HASH = dict(num_levels=8, log2_hashmap_size=13, base_res=4, max_res=128)


def _tamper(key, value):
    def change(m):
        return {**m, "hash": {**m["hash"], key: value}}
    return change


@pytest.mark.parametrize("change, expect, match", [
    (None, None, None),
    (_tamper("table_shape", [8 * 4096, 2]), None, "table_shape"),
    (_tamper("direct", [True] * 8), None, "direct"),
    (None, dict(SMOKE_HASH, log2_hashmap_size=12), "log2_hashmap_size"),
    (None, dict(SMOKE_HASH, mode="cell"), "mode 'corner' vs 'cell'"),
    (None, GridEncodingConfig(), "encodes with 'hash'"),
    (lambda m: {k: v for k, v in m.items() if k != "hash"}, None, "no grid entry, nor a hash"),
], ids=["round-trip", "table-shape", "direct", "log2", "mode", "grid-config", "no-entry"])
def test_hash_manifest_round_trips_and_refuses_a_mismatch(tmp_path, change, expect, match):
    """The manifest records the hash field's config and layout;
    ``grid_from_manifest`` rebuilds it, and raises on a record that its own
    fields do not rebuild, on another hash layout, or on a grid config."""
    enc = HashEncodingConfig(**SMOKE_HASH)
    ck.write_manifest(tmp_path, "fruit_nerf_smoke", np.eye(4)[:3], 1.0, np.zeros((2, 3)), 5, enc)
    m = ck.read_manifest(tmp_path)
    assert m["hash"]["rows"] == [8192] * 8 and m["hash"]["direct"] == [True] * 4 + [False] * 4  # res 4, 6, 10, 17 direct
    if change is not None:
        m = change(m)
    if isinstance(expect, dict):
        expect = HashEncodingConfig(**expect)
    if match is None:
        assert ck.grid_from_manifest(m, enc) == enc
        return
    with pytest.raises(ValueError, match=match):
        ck.grid_from_manifest(m, expect)


def test_reads_a_jax_smoke_checkpoint(tmp_path):
    """A JAX smoke ``ckpt_*.msgpack`` (three hash tables) written with flax,
    read without it: every leaf equals the bridge's conversion."""
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jconfigs.fruit_nerf_smoke(5), 5)
    jstate = jstate.replace(step=jax.numpy.asarray(250, jax.numpy.int32))
    path = tmp_path / "ckpt_000000250.msgpack"
    path.write_bytes(flax.serialization.to_bytes(jstate))
    model = configs.fruit_nerf_smoke(5).model
    params, step = ck.read_jax_checkpoint(path, model, "cpu")
    assert step == 250
    assert params["model"]["field"]["hash_table"].shape == (8 * 8192, 2)
    assert [p["hash_table"].shape for p in params["model"]["proposal_networks"]] == [(4 * 2048, 2)] * 2
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jstate.params), model, "cpu")
    got_leaves, want_leaves = bridge.tree_leaves(params), bridge.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
    back = bridge.params_to_jax(params, model)
    np.testing.assert_array_equal(back["model"]["field"]["hash_table"],
                                  np.asarray(jstate.params["model"]["field"]["hash_table"]))


def test_bridge_rejects_a_mismatched_hash_table():
    tree = jax.tree.map(np.asarray, jax_init_train_state(
        jax.random.PRNGKey(0), jconfigs.fruit_nerf_smoke(5), 5).params)
    model = configs.fruit_nerf_smoke(5).model
    wrong = dataclasses.replace(model, field=dataclasses.replace(
        model.field, hash=HashEncodingConfig(**dict(SMOKE_HASH, log2_hashmap_size=12))))
    with pytest.raises(ValueError, match="layout wants"):
        bridge.params_from_jax(tree, wrong, "cpu")
