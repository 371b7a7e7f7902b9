"""Every preset x variant of the port against the JAX package's
(tests/test_configs_presets.py mirrored): each routes to the same encoding
and every config field equals JAX's (dtypes by name): layouts, MLP sizes,
sample counts, optimizer names and rates, the split and max_train_images.
Unknown names raise KeyError. The grid variants of the big and huge presets
(tables cut to 2048 rows a level, float32, samples shrunk as the JAX test
shrinks them) give JAX's ``forward_train`` on bridged parameters, and a big
run's overrides survive its manifest."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import _shared_fields
from test_torch_orchard_e2e import cli

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.core.rays import RayBundle as JaxBundle
from fruitnerf_tpu.models.fruit_model import forward_train as jax_forward_train
from fruitnerf_tpu.models.fruit_model import init_fruit_model as jax_init_fruit_model
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.data.fixture import write_scene_capture
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.checkpoints import read_manifest
from fruitnerf_tpu_torch.engine.runs import load_run
from fruitnerf_tpu_torch.models.fruit_model import forward_train

PRESETS = ["fruit_nerf", "fruit_nerf_big", "fruit_nerf_huge"]
VARIANTS = ["grid", "tpu", "parity"]
# float32 on both sides, 8 rays: the renders agree to this (observed <= 2e-6)
RENDER_ATOL = 1e-5


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_preset_variant_matches_jax(preset, variant):
    port = configs.get_preset(preset, 4, variant=variant)
    ref = jconfigs.get_preset(preset, num_images=4, variant=variant)
    expected = {"tpu": "freq", "grid": "grid", "parity": "hash"}[variant]
    assert port.model.field.encoding == ref.model.field.encoding == expected
    _shared_fields(ref, port)
    for group in ("fields_opt", "proposal_opt", "appearance_opt", "camera_opt"):
        assert getattr(port, group).name == getattr(ref, group).name, group
    assert (port.train_split_fraction, port.max_train_images) == \
        (ref.train_split_fraction, ref.max_train_images)
    if variant == "grid":  # per-level rows cap at the preset's table size
        layout = port.model.field.grid.level_layout()
        assert max(t for t, _, _, _ in layout) == port.model.field.grid.table_size
    if variant == "tpu":
        assert port.model.field.encoding_config is None
        assert port.model.field.base_mlp.num_layers == ref.model.field.base_mlp.num_layers == 4
        assert port.model.field.base_mlp.in_dim == ref.model.field.base_mlp.in_dim


def test_smoke_preset_matches_jax():
    _shared_fields(jconfigs.fruit_nerf_smoke(4), configs.fruit_nerf_smoke(4))
    assert configs.fruit_nerf_smoke(4).max_train_images is None


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="fruit_nerf"):
        configs.get_preset("typo", 1)
    with pytest.raises(KeyError, match="variant"):
        configs.get_preset("fruit_nerf_big", 1, variant="typo")
    assert set(configs.PRESETS) == set(jconfigs.PRESETS)


def _bundles(n=8):
    dirs = np.zeros((n, 3), np.float32)
    dirs[:, 2] = -1.0
    dirs[:, 0] = np.linspace(-0.3, 0.3, n)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros((n, 3), np.float32)
    origins[:, 2] = 1.5
    args = (origins, dirs, np.full((n,), 0.1, np.float32), np.full((n,), 4.0, np.float32),
            np.zeros((n,), np.int32))
    jb = JaxBundle(*(jnp.asarray(a) for a in args))
    tb = RayBundle(*(torch.tensor(a) for a in args[:4]), torch.zeros(n, dtype=torch.int64))
    return jb, tb


@pytest.mark.parametrize("preset", ["fruit_nerf_big", "fruit_nerf_huge"])
def test_grid_forward_matches_jax(preset):
    """tests/test_configs_presets.py's forward step (8 rays, 2048 rows a
    level, samples (8, 4) and 4), on the port with the JAX parameters and
    the JAX step's sampler draws."""
    def shrink(cfg):
        return dataclasses.replace(cfg.model, num_nerf_samples=4, num_proposal_samples=(8, 4))

    jmodel = shrink(jconfigs.get_preset(preset, num_images=4, variant="grid",
                                        grid_table_size=2048, compute_dtype=jnp.float32))
    tcfg = configs.get_preset(preset, 4, variant="grid", grid_table_size=2048,
                              compute_dtype=torch.float32)
    tmodel = shrink(tcfg)
    tmodel = dataclasses.replace(tmodel, proposal_nets=tuple(
        dataclasses.replace(p, compute_dtype=torch.float32) for p in tmodel.proposal_nets))
    jmodel = dataclasses.replace(jmodel, proposal_nets=tuple(
        dataclasses.replace(p, compute_dtype=jnp.float32) for p in jmodel.proposal_nets))
    jparams = jax_init_fruit_model(jax.random.PRNGKey(0), jmodel)
    tree = {"model": jax.tree.map(np.asarray, jparams), "camera_opt": np.zeros((4, 6), np.float32)}
    tparams = bridge.params_from_jax(tree, tmodel, "cpu")["model"]
    jb, tb = _bundles()
    key = jax.random.PRNGKey(1)
    draws = [torch.tensor(np.asarray(jax.random.uniform(k, (8, 1))))
             for k in jax.random.split(key, 3)]
    jout = jax_forward_train(jparams, jb, jmodel, key=key, step=jnp.asarray(100), train=True)
    with torch.no_grad():
        tout = forward_train(tparams, tb, tmodel, draws, step=100, train=True)
    for k in ("rgb", "accumulation", "depth", "semantics"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=RENDER_ATOL,
                                   rtol=1e-4, err_msg=k)
    assert tparams["field"]["grid_table"].shape == (16 * 2048, 16)


def test_big_run_overrides_survive_the_manifest(tmp_path):
    """Two ``fruit_nerf_big`` steps on a capture, with overrides: the
    manifest records them and the kept train images, and ``load_run``
    rebuilds the trained config from it."""
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=6, image_size=16,
                                              num_leaves=4), device="cpu")
    write_scene_capture(scene, tmp_path / "capture")
    run = tmp_path / "run"
    cli("train", "--preset", "fruit_nerf_big", "--data", tmp_path / "capture",
        "--output-dir", run, "--max-iters", 2, "--train-rays-per-batch", 16,
        "--sparsity-loss", 0.005, "--device", "cpu")
    m = read_manifest(run)
    assert m["preset"] == "fruit_nerf_big" and m["variant"] == "grid"
    assert m["config_overrides"] == {"train_rays_per_batch": 16, "sparsity_loss": 0.005}
    assert m["num_train_images"] == 6 and m["train_split_fraction"] == 0.99
    _, config, state = load_run(run, "cpu")
    assert config.train_rays_per_batch == 16 and config.model.density_sparsity_mult == 0.005
    assert state.step == 2 and config.fields_opt.name == "radam"


@pytest.mark.parametrize("preset, variant", [("fruit_nerf_big", "grid"),
                                             ("fruit_nerf_huge", "parity"),
                                             ("fruit_nerf", "tpu")])
def test_reads_a_jax_checkpoint_of_each_preset(tmp_path, preset, variant):
    """A JAX ``ckpt_*.msgpack`` of the preset read through
    ``read_jax_checkpoint``: the big grid's cell table (16 levels of up to
    16384 rows, no two-tier cap), the huge parity's 2^21-entry corner table (two of its 16 levels,
    to keep the file small) and 2^18-entry proposal tables, the tpu
    variant's tableless field; every leaf equals the bridge's conversion,
    and the way back gives the JAX tables."""
    import flax.serialization

    from fruitnerf_tpu.engine.trainer import init_train_state as jax_init_train_state
    from fruitnerf_tpu_torch.engine import checkpoints as ck

    def cut(cfg):
        if variant != "parity":
            return cfg
        field = dataclasses.replace(cfg.model.field, hash=dataclasses.replace(
            cfg.model.field.hash, num_levels=2))
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, field=field))

    jcfg = cut(jconfigs.get_preset(preset, num_images=4, variant=variant))
    tcfg = cut(configs.get_preset(preset, 4, variant=variant))
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, 4)
    jstate = jstate.replace(step=jnp.asarray(100, jnp.int32))
    path = tmp_path / "ckpt_000000100.msgpack"
    path.write_bytes(flax.serialization.to_bytes(jstate))
    params, step = ck.read_jax_checkpoint(path, tcfg.model, "cpu")
    assert step == 100
    field = params["model"]["field"]
    if variant == "grid":
        grid = tcfg.model.field.grid
        assert field["grid_table"].shape == grid.table_shape
        assert max(t for t, _, _, _ in grid.level_layout()) == 16384
    elif variant == "parity":
        assert field["hash_table"].shape == (2 * 2**21, 2)
        assert [p["hash_table"].shape for p in params["model"]["proposal_networks"]] == \
            [(7 * 2**18, 2)] * 2
    else:
        assert not any("table" in k for k in field)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg.model, "cpu")
    for a, b in zip(bridge.tree_leaves(params), bridge.tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    back = bridge.params_to_jax(params, tcfg.model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jstate.params)),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
