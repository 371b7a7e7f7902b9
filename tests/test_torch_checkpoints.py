"""fruitnerf_tpu_torch.engine.checkpoints: the atomic save and its restore,
the shape check against a template, the manifest (the JAX package's schema
plus the resolved grid layout), and reading a checkpoint the JAX package
wrote with flax."""
import dataclasses
import json

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.engine import checkpoints as jck
from fruitnerf_tpu.engine.trainer import init_train_state as jax_init_train_state
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig

CORNER = dict(num_levels=3, table_size=256, base_res=4, max_res=32, mode="corner")
CELL = dict(num_levels=3, table_size=256, base_res=4, max_res=32, mid_table_size=128,
            fine_levels=1)
N_CAMS = 4


def _config(grid: dict):
    cfg = configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32)
    m = cfg.model
    field = dataclasses.replace(m.field, grid=GridEncodingConfig(**grid), hidden_dim=16,
                                hidden_dim_color=16, hidden_dim_semantic=16,
                                appearance_embed_dim=4)
    return dataclasses.replace(cfg, model=dataclasses.replace(m, field=field))


def _optimizer_step(state, config):
    """The optimizer part of ``trainer.train_step``, on the gradients set."""
    trainer.stage_scalars(state, config)
    trainer.optimizer_step(state, config)


def _trained_state(grid: dict, seed=0):
    """A state whose optimizer holds moments: one Adam step on random grads."""
    state = trainer.init_train_state(_config(grid), N_CAMS, "cpu",
                                     generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for t in bridge.tree_leaves(state.params):
        t.grad = torch.randn(t.shape, generator=g)
    _optimizer_step(state, _config(grid))
    state.step = 7
    return state


def test_save_and_load_round_trip(tmp_path):
    state = _trained_state(CORNER)
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)  # the loop's generator mid-run
    path = ck.save_checkpoint(tmp_path, state, gen)
    assert path.name == "ckpt_000000007.pt"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_000000007.pt"]  # no temp left
    fresh = trainer.init_train_state(_config(CORNER), N_CAMS, "cpu",
                                     generator=torch.Generator().manual_seed(9))
    gen2 = torch.Generator()
    restored, resumed = ck.resume_from_latest(tmp_path, fresh, gen2)
    assert resumed and restored is fresh and restored.step == 7
    for a, b in zip(bridge.tree_leaves(state.params), bridge.tree_leaves(restored.params)):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(gen.get_state(), gen2.get_state())
    # restored parameters are the optimizer's: a step moves them
    w0 = restored.params["model"]["field"]["base_mlp"]["w0"]
    before = w0.detach().clone()
    for t in bridge.tree_leaves(restored.params):
        t.grad = torch.ones_like(t)
    _optimizer_step(restored, _config(CORNER))
    assert not torch.equal(before, w0)


def _reversed_dicts(tree):
    if isinstance(tree, dict):
        return {k: _reversed_dicts(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reversed_dicts(v) for v in tree]
    return tree


def test_optimizer_state_restores_by_parameter_not_by_dict_order(tmp_path):
    """A state whose parameter dicts were built in another key order (as
    the bridge's are) restores each Adam moment onto the same parameter."""
    src = _trained_state(CORNER)
    params = _reversed_dicts(src.params)
    state = trainer.init_train_state(_config(CORNER), N_CAMS, "cpu", params=params)
    state.optimizer.load_state_dict(src.optimizer.state_dict())
    state.step = src.step
    ck.save_checkpoint(tmp_path, state)
    fresh = trainer.init_train_state(_config(CORNER), N_CAMS, "cpu")
    ck.load_checkpoint(ck.latest_checkpoint(tmp_path), fresh)
    for a, b in zip(bridge.tree_leaves(src.params), bridge.tree_leaves(fresh.params)):
        assert torch.equal(src.optimizer.state[a]["exp_avg"], fresh.optimizer.state[b]["exp_avg"])


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous checkpoint the latest
    and no partial ``ckpt_*.pt``."""
    state = _trained_state(CORNER)
    ck.save_checkpoint(tmp_path, state)

    def dies_mid_write(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", dies_mid_write)
    state.step = 9
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint(tmp_path, state)
    assert ck.latest_checkpoint(tmp_path).name == "ckpt_000000007.pt"
    assert not (tmp_path / "ckpt_000000009.pt").exists()


def test_load_refuses_a_mismatched_template(tmp_path):
    """A corner checkpoint into a cell config's state: ValueError naming
    the grid table's path and both shapes."""
    path = ck.save_checkpoint(tmp_path, _trained_state(CORNER))
    cell_state = trainer.init_train_state(_config(CELL), N_CAMS, "cpu")
    with pytest.raises(ValueError, match=r"/model/field/grid_table: ckpt \(768, 2\) vs "
                                         r"template \(\d+, 16\)"):
        ck.load_checkpoint(path, cell_state)
    assert cell_state.step == 0


def test_manifest_records_the_grid_layout(tmp_path):
    grid = GridEncodingConfig(**CORNER)
    args = ("fruit_nerf", np.eye(4)[:3], 0.5, np.array([[-1.0] * 3, [1.0] * 3]), N_CAMS)
    ck.write_manifest(tmp_path / "port", *args, grid=grid, extra={"variant": "grid"})
    jck.write_manifest(tmp_path / "jax", *args, extra={"variant": "grid"})
    m = ck.read_manifest(tmp_path / "port")
    ref = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert set(m) == set(ref) | {"grid"}  # the JAX package's schema plus the layout
    assert all(m[k] == ref[k] for k in ref if k != "framework")
    g = m["grid"]
    assert (g["mode"], g["features_per_level"], g["table_shape"]) == ("corner", 2, [768, 2])
    assert g["rows"] == [256] * 3 and g["caps"] == [256] * 3
    assert g["direct"] == [(r + 1) ** 3 <= 256 for r in g["resolutions"]]
    assert ck.grid_from_manifest(m) == grid
    assert ck.grid_from_manifest(m, expect=grid) == grid
    cell = GridEncodingConfig(**CELL)
    with pytest.raises(ValueError, match="mode 'corner' vs 'cell'"):
        ck.grid_from_manifest(m, expect=cell)
    tampered = dict(m, grid=dict(g, rows=[128] * 3))
    with pytest.raises(ValueError, match="rows"):
        ck.grid_from_manifest(tampered)


def test_cell_manifest_records_the_two_tier_caps(tmp_path):
    grid = GridEncodingConfig(**CELL)
    ck.write_manifest(tmp_path, "fruit_nerf", np.eye(4)[:3], 1.0, np.zeros((2, 3)), N_CAMS, grid)
    m = ck.read_manifest(tmp_path)
    assert m["grid"]["caps"] == [128, 128, 256]
    assert m["grid"]["rows"] == list(grid.cell_layout().rows)
    assert ck.grid_from_manifest(m) == grid
    with pytest.raises(ValueError, match="mid_table_size"):
        ck.grid_from_manifest(m, expect=dataclasses.replace(grid, mid_table_size=None))


def _tamper(field, value):
    def fn(manifest):
        return dict(manifest, grid=dict(manifest["grid"], **{field: value}))
    return fn


@pytest.mark.parametrize("grid, change, expect, match", [
    # the recorded layout is not what its own fields rebuild
    (CORNER, _tamper("rows", [128] * 3), None, "rows"),
    (CELL, _tamper("direct", [False] * 3), None, "direct"),
    (CELL, _tamper("caps", [256] * 3), None, "caps"),
    # the config about to restore the run has another layout
    (CORNER, None, CELL, "mode 'corner' vs 'cell'"),
    (CELL, None, dict(CELL, table_size=512), "table_size"),
    (CELL, None, dict(CELL, fine_levels=2), "fine_levels"),
    (CORNER, None, dict(CORNER, features_per_level=4), "features_per_level"),
    # a manifest the JAX package wrote, which has no grid entry
    (CELL, lambda m: {k: v for k, v in m.items() if k != "grid"}, None, "no grid entry"),
], ids=["rows", "direct", "caps", "mode", "table-size", "fine-levels", "features", "no-grid"])
def test_grid_from_manifest_refuses_a_mismatch(tmp_path, grid, change, expect, match):
    """One function rebuilds the layout and refuses a mismatch, against the
    record itself or against ``expect``."""
    ck.write_manifest(tmp_path, "fruit_nerf", np.eye(4)[:3], 1.0, np.zeros((2, 3)), N_CAMS,
                      GridEncodingConfig(**grid))
    m = ck.read_manifest(tmp_path)
    if change is not None:
        m = change(m)
    with pytest.raises(ValueError, match=match):
        ck.grid_from_manifest(m, None if expect is None else GridEncodingConfig(**expect))


@pytest.mark.parametrize("grid", [CORNER, CELL], ids=["corner", "cell"])
def test_reads_a_flax_checkpoint(tmp_path, grid):
    """A JAX ``ckpt_*.msgpack`` written with flax, read without it."""
    jcfg = jconfigs.fruit_nerf(N_CAMS)
    field = dataclasses.replace(jcfg.model.field, grid=JaxGrid(**grid))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, field=field))
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    jstate = jstate.replace(step=jax.numpy.asarray(1234, jax.numpy.int32))
    path = tmp_path / "ckpt_000001234.msgpack"
    path.write_bytes(flax.serialization.to_bytes(jstate))
    tgrid = GridEncodingConfig(**grid)
    tmodel = configs.fruit_nerf(N_CAMS).model
    tmodel = dataclasses.replace(tmodel, field=dataclasses.replace(tmodel.field, grid=tgrid))
    params, step = ck.read_jax_checkpoint(path, tmodel, "cpu")
    assert step == 1234
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jstate.params), tmodel, "cpu")
    assert params["model"]["field"]["grid_table"].shape == tgrid.table_shape
    got_leaves, want_leaves = bridge.tree_leaves(params), bridge.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
