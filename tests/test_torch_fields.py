"""The port's fields (fruitnerf_tpu_torch/fields) against their JAX twins on
bridged parameters: the encodings, the MLP, the frequency proposal field and
the grid FruitField, values and parameter gradients, float32 compute on
both sides (the JAX grid runs its Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu.fields import encodings as jenc
from fruitnerf_tpu.fields import freq_density_field as jfreq
from fruitnerf_tpu.fields import fruit_field as jff
from fruitnerf_tpu.fields import mlp as jmlp
from fruitnerf_tpu_torch import bridge
from fruitnerf_tpu_torch.fields import encodings as tenc
from fruitnerf_tpu_torch.fields import freq_density_field as tfreq
from fruitnerf_tpu_torch.fields import fruit_field as tff
from fruitnerf_tpu_torch.fields import mlp as tmlp
from fruitnerf_tpu_torch.models.fruit_model import FruitModelConfig

ATOL = 1e-5  # float32 MLP outputs of O(1)
GRAD_RTOL = 1e-4  # parameter gradients, relative to each one's max magnitude
GRID = dict(num_levels=4, table_size=512, base_res=4, max_res=64,
            mid_table_size=256, fine_levels=2)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree, grad=True)


def _close(actual, expected, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected), atol=atol, rtol=rtol)


def _grad_close(actual, expected):
    expected = np.asarray(expected)
    err = np.abs(actual.numpy() - expected).max()
    assert err <= GRAD_RTOL * max(np.abs(expected).max(), 1e-30), err


def test_sh_and_nerf_encode():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for levels in (1, 2, 3, 4):
        _close(tenc.sh_encode(_t(d), levels), jenc.sh_encode(jnp.asarray(d), levels), atol=1e-6)
    x = rng.uniform(-1, 1, (4, 5, 3)).astype(np.float32)
    _close(tenc.nerf_encode(_t(x), 7),
           jenc.nerf_encode(jnp.asarray(x), 7, include_input=True), atol=2e-5)


def test_mlp_init_shapes_and_forward():
    cfg = tmlp.MLPConfig(in_dim=9, num_layers=3, hidden_dim=16, out_dim=4, out_sigmoid=True)
    jcfg = jmlp.MLPConfig(in_dim=9, num_layers=3, hidden_dim=16, out_dim=4,
                          out_activation="sigmoid")
    jparams = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0), jcfg))
    tparams = tmlp.init_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in tparams.items()} == {k: v.shape for k, v in jparams.items()}
    bound = (6.0 / 9) ** 0.5
    assert float(tparams["w0"].abs().max()) <= bound and float(tparams["b0"].abs().max()) == 0
    x = np.random.default_rng(1).normal(size=(2, 7, 9)).astype(np.float32)
    _close(tmlp.apply_mlp(_tree_t(jparams), _t(x), cfg), jmlp.apply_mlp(jparams, jnp.asarray(x), jcfg))


def test_freq_proposal_field_value_and_grads():
    jcfg = jfreq.FreqDensityFieldConfig(num_frequencies=5, num_layers=2, hidden_dim=32,
                                        compute_dtype=jnp.float32)
    tcfg = tfreq.FreqDensityFieldConfig(num_frequencies=5, num_layers=2, hidden_dim=32,
                                        compute_dtype=torch.float32)
    jparams = jax.tree.map(np.asarray, jfreq.init_freq_density_field(jax.random.PRNGKey(2), jcfg))
    pos = np.random.default_rng(3).normal(0, 1.5, (8, 6, 3)).astype(np.float32)
    tparams = _tree_t(jparams)
    dens = tfreq.freq_density_field_forward(tparams, _t(pos), tcfg)
    dens.sum().backward()
    jd, jg = jax.value_and_grad(
        lambda p: jnp.sum(jfreq.freq_density_field_forward(p, jnp.asarray(pos), jcfg))
    )(jparams)
    _close(dens, jfreq.freq_density_field_forward(jparams, jnp.asarray(pos), jcfg), rtol=1e-4)
    for k in ("w0", "w1", "b0"):
        _grad_close(tparams["mlp"][k].grad, jg["mlp"][k])


def _field_configs(num_images=4):
    kw = dict(num_images=num_images, hidden_dim=32, geo_feat_dim=15, hidden_dim_color=32,
              hidden_dim_semantic=32, appearance_embed_dim=8, density_bias=-1.0)
    jcfg = jff.FruitFieldConfig(grid=jenc.GridEncodingConfig(mode="cell", **GRID),
                                encoding="grid", compute_dtype=jnp.float32, **kw)
    tcfg = tff.FruitFieldConfig(grid=tenc.GridEncodingConfig(**GRID),
                                compute_dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fruit_field_forward_on_bridged_params(train):
    jcfg, tcfg = _field_configs()
    jparams = jax.tree.map(np.asarray, jff.init_fruit_field(jax.random.PRNGKey(4), jcfg))
    # O(1) table entries so the grid's contribution is visible
    jparams["grid_table"] = tuple(t * 1e4 for t in jparams["grid_table"])
    rng = np.random.default_rng(5)
    pos = rng.normal(0, 0.8, (6, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ci = rng.integers(0, 4, 6)
    probe = {k: rng.normal(size=s).astype(np.float32)
             for k, s in (("density", (6, 8)), ("rgb", (6, 8, 3)), ("semantics", (6, 8, 1)))}

    def jloss(p):
        out = jff.fruit_field_forward(p, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(ci),
                                      jcfg, train=train)
        return sum(jnp.sum(out[k] * probe[k]) for k in probe), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = _tree_t(bridge.params_from_jax(
        {"model": {"field": jparams, "proposal_networks": []}, "camera_opt": np.zeros((1, 6))},
        FruitModelConfig(field=tcfg, proposal_nets=()), "cpu")["model"]["field"])
    tout = tff.fruit_field_forward(tparams, _t(pos), _t(dirs), _t(ci), tcfg, train=train)
    sum(torch.sum(tout[k] * _t(probe[k])) for k in probe).backward()
    for k in probe:
        _close(tout[k], jout[k], rtol=1e-4)
    _grad_close(tparams["grid_table"].grad, bridge.grid_table_from_jax(jg["grid_table"], tcfg.grid))
    for group in ("base_mlp", "color_mlp", "semantic_mlp", "semantic_head"):
        for k, v in tparams[group].items():
            _grad_close(v.grad, jg[group][k])
    _grad_close(tparams["appearance"].grad, jg["appearance"])


def test_semantic_head_does_not_train_geometry():
    """The semantic MLP reads detached geo features: semantics alone give
    the grid and the base MLP no gradient."""
    _, tcfg = _field_configs()
    p = tff.init_fruit_field(tcfg, torch.Generator().manual_seed(0), "cpu")
    for v in (p["grid_table"], p["base_mlp"]["w0"], p["semantic_mlp"]["w0"]):
        v.requires_grad_(True)
    out = tff.fruit_field_forward(p, torch.rand(3, 4, 3), torch.rand(3, 3),
                                  torch.zeros(3, dtype=torch.int64), tcfg, train=True)
    out["semantics"].sum().backward()
    assert p["grid_table"].grad is None and p["base_mlp"]["w0"].grad is None
    assert p["semantic_mlp"]["w0"].grad is not None
