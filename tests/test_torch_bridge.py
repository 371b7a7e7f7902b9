"""fruitnerf_tpu_torch.bridge and configs: a grid-variant JAX parameter tree
round-trips through the port's layout, and the port's fruit_nerf preset and
overrides match the JAX package's field for field."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.engine.trainer import init_train_state as jax_init_train_state
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig

GRID = dict(num_levels=4, table_size=512, base_res=4, max_res=64,
            mid_table_size=256, fine_levels=2)


def _small_jax_config():
    cfg = jconfigs.fruit_nerf(5)
    field = dataclasses.replace(cfg.model.field, grid=JaxGrid(**GRID))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, field=field))


def test_grid_variant_params_round_trip():
    jcfg = _small_jax_config()
    state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, 5)
    tree = jax.tree.map(np.asarray, state.params)
    grid = GridEncodingConfig(**GRID)
    model = dataclasses.replace(configs.fruit_nerf(5).model, field=dataclasses.replace(
        configs.fruit_nerf(5).model.field, grid=grid))
    params = bridge.params_from_jax(tree, model, torch.device("cpu"))

    field = params["model"]["field"]
    assert field["grid_table"].shape == (grid.cell_layout().total_rows, 16)
    assert field["grid_table"].dtype == torch.float32
    # level 1's cell t sits at flat row offset_1 + t
    off = grid.cell_layout().offsets[1]
    np.testing.assert_array_equal(
        field["grid_table"][off + 5].numpy(),
        tree["model"]["field"]["grid_table"][1].reshape(-1, 16)[5],
    )
    assert len(params["model"]["proposal_networks"]) == 2

    back = bridge.params_to_jax(params, model)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(
        jax.tree.map(np.asarray, back, is_leaf=lambda x: isinstance(x, np.ndarray))
    )
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the bridge copies: the port's tensors do not alias the JAX arrays
    field["appearance"].add_(1.0)
    assert not np.array_equal(field["appearance"].numpy(), tree["model"]["field"]["appearance"])


def test_bridge_rejects_a_mismatched_layout():
    tree = jax.tree.map(np.asarray, jax_init_train_state(
        jax.random.PRNGKey(0), _small_jax_config(), 5).params)
    wrong = GridEncodingConfig(**dict(GRID, mid_table_size=None))
    model = configs.fruit_nerf(5).model
    model = dataclasses.replace(model, field=dataclasses.replace(model.field, grid=wrong))
    with pytest.raises(ValueError, match="layout wants"):
        bridge.params_from_jax(tree, model, torch.device("cpu"))


def _shared_fields(a, b, skip=()):
    """Compare dataclass fields present on both sides (dtypes by name)."""
    for f in dataclasses.fields(b):
        if f.name in skip or not hasattr(a, f.name):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _shared_fields(va, vb, skip)
        elif isinstance(vb, tuple) and vb and dataclasses.is_dataclass(vb[0]):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                _shared_fields(x, y, skip)
        elif isinstance(vb, torch.dtype):
            assert str(vb).removeprefix("torch.") == np.dtype(va).name, f.name
        else:
            assert va == vb, (f.name, va, vb)


@pytest.mark.parametrize("overrides", [
    {},
    {"sparsity_loss": 0.005},
    {"sparsity_loss": 0.005, "mid_table_size": 2048, "fine_levels": 2,
     "camera_opt": False, "nerf_samples": 32, "density_bias": 0.0},
], ids=["preset", "orchard_e2e", "mixed"])
def test_preset_and_overrides_match_jax(overrides):
    port = configs.apply_overrides(configs.fruit_nerf(7), overrides)
    ref = jconfigs.apply_overrides(jconfigs.fruit_nerf(7), overrides)
    _shared_fields(ref, port)
    assert configs.OVERRIDE_KEYS == jconfigs.OVERRIDE_KEYS
    with pytest.raises(KeyError, match="unknown"):
        configs.apply_overrides(port, {"no_such_key": 1})


def test_unported_variants_raise():
    """Every variant of the JAX package is ported; a name it does not have
    raises (the tpu variant builds, with its tableless field)."""
    with pytest.raises(KeyError, match="variant"):
        configs.fruit_nerf(3, variant="tpu_v2")
    assert configs.fruit_nerf(3, variant="tpu").model.field.encoding == "freq"
    with pytest.raises(ValueError, match="power of two"):
        GridEncodingConfig(table_size=3000)
