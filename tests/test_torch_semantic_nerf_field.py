"""The port's SemanticNeRFField (tests/test_semantic_nerf_field.py
mirrored) and its forward and gradients against the JAX package's on
bridged parameters; and ``models/fruit_model.py:forward_inference`` against
the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fields import _close, _grad_close, _t, _tree_t
from test_torch_sampler_options import R, _bundles

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.fields import semantic_nerf_field as jsn
from fruitnerf_tpu.models import fruit_model as jfm
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.fields import semantic_nerf_field as tsn
from fruitnerf_tpu_torch.models import fruit_model as tfm

SMALL = dict(hidden_dim=32, hidden_dim_semantic=16)
ATOL = 1e-5  # float32 outputs of O(1); densities up to ~10 are held relatively (1e-5)


def _inputs(r=5, s=7, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (r, s, 3)).astype(np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (r, 1))
    return pos, dirs


def test_forward_shapes_and_ranges():
    cfg = tsn.SemanticNerfFieldConfig(**SMALL)
    params = tsn.init_semantic_nerf_field(cfg, torch.Generator().manual_seed(0), "cpu")
    pos, dirs = _inputs()
    out = tsn.semantic_nerf_forward(params, _t(pos), _t(dirs), cfg)
    assert out["density"].shape == (5, 7) and out["rgb"].shape == (5, 7, 3)
    assert out["semantics"].shape == (5, 7, 1)
    assert bool((out["density"] >= 0).all())
    assert 0 <= float(out["rgb"].min()) and float(out["rgb"].max()) <= 1


def test_semantic_branch_detached():
    cfg = tsn.SemanticNerfFieldConfig(**SMALL)
    params = tsn.init_semantic_nerf_field(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in bridge.tree_leaves(params):
        t.requires_grad_(True)
    pos, dirs = _inputs(3, 4)
    (tsn.semantic_nerf_forward(params, _t(pos), _t(dirs), cfg)["semantics"] ** 2).sum().backward()
    assert params["base_mlp"]["w0"].grad is None
    assert float(params["semantic_mlp"]["w0"].grad.abs().sum()) > 0


def test_overfits_single_point_density():
    cfg = tsn.SemanticNerfFieldConfig(hidden_dim=32, num_layers_base=2)
    params = tsn.init_semantic_nerf_field(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = bridge.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    pos, dirs = torch.tensor([[[0.2, 0.1, -0.3]]]), torch.tensor([[0.0, 0.0, 1.0]])

    def loss():
        return (tsn.semantic_nerf_forward(params, pos, dirs, cfg)["density"][0, 0] - 5.0) ** 2

    l0 = loss().item()
    for _ in range(50):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert loss().item() < l0 * 0.1


@pytest.mark.parametrize("pass_grads", [False, True])
def test_forward_and_grads_match_jax(pass_grads):
    kw = dict(SMALL, pass_semantic_gradients=pass_grads)
    jcfg, tcfg = jsn.SemanticNerfFieldConfig(**kw), tsn.SemanticNerfFieldConfig(**kw)
    jparams = jax.tree.map(np.asarray, jsn.init_semantic_nerf_field(jax.random.PRNGKey(0), jcfg))
    tparams = _tree_t(jparams)
    assert {k: {n: t.shape for n, t in v.items()} for k, v in tparams.items()} == {
        k: {n: t.shape for n, t in v.items()}
        for k, v in tsn.init_semantic_nerf_field(tcfg, torch.Generator(), "cpu").items()}
    pos, dirs = _inputs()
    out = tsn.semantic_nerf_forward(tparams, _t(pos), _t(dirs), tcfg)

    def jfwd(p):
        return jsn.semantic_nerf_forward(p, jnp.asarray(pos), jnp.asarray(dirs), jcfg)

    jout = jfwd(jparams)
    for k in ("density", "rgb", "semantics"):
        _close(out[k], jout[k], atol=ATOL, rtol=1e-5)
    sum(v.sum() for v in out.values()).backward()
    jg = jax.grad(lambda p: sum(jnp.sum(v) for v in jfwd(p).values()))(jparams)
    for name in ("base_mlp", "density_head", "color_mlp", "semantic_mlp"):
        _grad_close(tparams[name]["w0"].grad, jg[name]["w0"])


def test_forward_inference_matches_jax():
    """The eval forward with the colormap repeated to 3 channels, on the
    smoke preset's bridged parameters."""
    jmodel = jconfigs.fruit_nerf_smoke(3).model
    tmodel = configs.fruit_nerf_smoke(3).model
    jparams = jfm.init_fruit_model(jax.random.PRNGKey(0), jmodel)
    tree = {"model": jax.tree.map(np.asarray, jparams), "camera_opt": np.zeros((3, 6), np.float32)}
    tparams = bridge.params_from_jax(tree, tmodel, "cpu")["model"]
    jb, tb = _bundles()
    jout = jax.jit(jfm.forward_inference, static_argnums=2)(jparams, jb, jmodel)
    with torch.no_grad():
        tout = tfm.forward_inference(tparams, tb, tmodel)
    assert tout["semantics_colormap"].shape == (R, 3)
    for k in ("rgb", "accumulation", "depth", "semantics", "semantics_colormap"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=2e-6, rtol=1e-4,
                                   err_msg=k)
    with torch.no_grad():
        ev = tfm.forward_train(tparams, tb, tmodel, None, step=1 << 30, train=False)
    torch.testing.assert_close(tout["semantics_colormap"], ev["semantics_colormap"].repeat(1, 3))
