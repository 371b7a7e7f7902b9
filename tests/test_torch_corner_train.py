"""The port's fruit_nerf field and train step with the grid in corner mode
(``dataclasses.replace(grid, mode="corner", mid_table_size=None)``, as the
JAX package selects it) against the JAX package: the field forward and its
gradients on bridged parameters, and one train step on the same parameters
and draws (the JAX step's, injected). Float32 compute on both sides; the
JAX grid runs its Pallas corner kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import N_CAMS, OVERRIDES, _assert_losses_close, _grad_errors, \
    _jax_draws, _shrink

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.fields import encodings as jenc
from fruitnerf_tpu.fields import fruit_field as jff
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields import encodings as tenc
from fruitnerf_tpu_torch.fields import fruit_field as tff

ATOL = 1e-5  # float32 field outputs of O(1)
GRAD_RTOL = 1e-4  # per leaf, relative to its max |g|
GRID = dict(num_levels=4, table_size=512, base_res=4, max_res=64, mode="corner")


def _field_configs(features):
    kw = dict(num_images=4, hidden_dim=32, geo_feat_dim=15, hidden_dim_color=32,
              hidden_dim_semantic=32, appearance_embed_dim=8, density_bias=-1.0)
    grid = dict(GRID, features_per_level=features)
    jcfg = jff.FruitFieldConfig(grid=jenc.GridEncodingConfig(**grid), encoding="grid",
                                compute_dtype=jnp.float32, **kw)
    tcfg = tff.FruitFieldConfig(grid=tenc.GridEncodingConfig(**grid),
                                compute_dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("features", [2, 4])
def test_corner_field_forward_and_grads_match_jax(features):
    jcfg, tcfg = _field_configs(features)
    assert tcfg.base_mlp.in_dim == tcfg.grid.out_dim == 4 * features
    jparams = jax.tree.map(np.asarray, jff.init_fruit_field(jax.random.PRNGKey(4), jcfg))
    assert jparams["base_mlp"]["w0"].shape[0] == tcfg.base_mlp.in_dim
    jparams["grid_table"] = jparams["grid_table"] * 1e4  # O(1) entries: visible grid terms
    rng = np.random.default_rng(5)
    pos = rng.normal(0, 0.8, (6, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ci = rng.integers(0, 4, 6)
    probe = {k: rng.normal(size=s).astype(np.float32)
             for k, s in (("density", (6, 8)), ("rgb", (6, 8, 3)), ("semantics", (6, 8, 1)))}

    def jloss(p):
        out = jff.fruit_field_forward(p, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(ci),
                                      jcfg, train=True)
        return sum(jnp.sum(out[k] * probe[k]) for k in probe), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = bridge.params_from_jax(
        {"model": {"field": jparams, "proposal_networks": []}, "camera_opt": np.zeros((1, 6))},
        tcfg.grid, "cpu")["model"]["field"]
    tparams = bridge.tree_map(tparams, lambda t: t.requires_grad_(True))
    assert tparams["grid_table"].shape == tcfg.grid.table_shape
    tout = tff.fruit_field_forward(tparams, torch.from_numpy(pos), torch.from_numpy(dirs),
                                   torch.from_numpy(ci), tcfg, train=True)
    sum(torch.sum(tout[k] * torch.from_numpy(probe[k])) for k in probe).backward()
    for k in probe:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=ATOL,
                                   rtol=1e-4, err_msg=k)
    want = bridge.table_from_jax(jg["grid_table"], tcfg.grid)
    assert np.abs(tparams["grid_table"].grad.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()
    w0 = np.asarray(jg["base_mlp"]["w0"])
    assert np.abs(tparams["base_mlp"]["w0"].grad.numpy() - w0).max() <= GRAD_RTOL * np.abs(w0).max()


def test_corner_train_step_matches_jax():
    """Step 0 on the same parameters and draws: every loss term, and every
    gradient leaf, the corner table's included."""
    scene = render_scene(SyntheticSceneConfig(
        num_fruits=4, image_size=24, num_cameras=N_CAMS, num_leaves=6))
    jgrid = jenc.GridEncodingConfig(**GRID)
    tgrid = tenc.GridEncodingConfig(**GRID)
    jcfg = _shrink(jconfigs.apply_overrides(
        jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32), OVERRIDES),
        jgrid, jnp.float32, chunk=100)
    tcfg = _shrink(configs.apply_overrides(
        configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32), OVERRIDES),
        tgrid, torch.float32, chunk=100)
    # the port selects corner mode from the preset as the JAX package does
    preset = configs.fruit_nerf(N_CAMS).model.field.grid
    assert dataclasses.replace(preset, mode="corner", mid_table_size=None).table_shape == \
        (16 * 8192, 2)
    jdata = jax_dataset_from_scene(scene)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    params0 = jax.tree.map(np.array, jstate.params)
    key = jax.random.PRNGKey(1)
    jnew, jm = jtrainer.make_train_step(jcfg)(jstate, jdata, key)
    tstate = trainer.init_train_state(
        tcfg, N_CAMS, "cpu", params=bridge.params_from_jax(params0, tgrid, "cpu"))
    tm = trainer.train_step(tstate, dataset_from_scene(scene, "cpu"), tcfg,
                            draws=_jax_draws(key, 0, jcfg, jdata))
    _assert_losses_close(jm, tm)
    errors = _grad_errors(jnew, tstate, tgrid)
    assert "/model/field/grid_table" in errors
    for path, (rel, _, _) in errors.items():
        assert rel <= GRAD_RTOL, (path, rel)
