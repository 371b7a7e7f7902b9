"""The ``tpu`` variant: the frequency-encoded FruitField (no table) against
the JAX package's on bridged parameters, forward and gradients, and one
shrunk ``fruit_nerf --variant tpu`` train step on the JAX step's draws,
which must give JAX's losses and step-0 gradients (as
tests/test_torch_train_step.py checks the grid step)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fields import ATOL, _close, _grad_close, _t, _tree_t
from test_torch_train_step import N_CAMS, OVERRIDES, _grad_errors, _jax_draws

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.fields import fruit_field as jff
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields import fruit_field as tff

# The 12th octave multiplies a sample's position by pi * 2^11 ~ 6434, so a
# float32 ulp of a position (the two frameworks place samples with rounding
# of their own) moves its sines by ~1e-3: nudging the port's own sampler
# draws by one ulp moves the step's losses by up to 9.6e-6 and its
# gradients by up to 1.1e-3 of a leaf's max. Against JAX, observed: losses
# <= 1.1e-5 relative, gradients <= 2.1e-3 (camera_opt, which reads the
# positions' derivative). The two encodings agree to 6e-8 on equal inputs.
STEP_LOSS_RTOL = 5e-5
STEP_GRAD_RTOL = 5e-3


def _field_configs(**kw):
    common = dict(num_images=3, encoding="freq", pos_frequencies=12, hidden_dim=32,
                  geo_feat_dim=7, hidden_dim_color=16, hidden_dim_semantic=16,
                  appearance_embed_dim=4, density_bias=-3.0, **kw)
    return jff.FruitFieldConfig(**common), tff.FruitFieldConfig(**common)


def test_freq_field_has_no_table_and_a_deeper_base_mlp():
    jcfg, tcfg = _field_configs()
    assert tcfg.table_key is None and tcfg.encoding_config is None
    assert (tcfg.base_mlp.in_dim, tcfg.base_mlp.num_layers) == \
        (jcfg.base_mlp.in_dim, jcfg.base_mlp.num_layers) == (3 + 6 * 12, 4)
    params = tff.init_fruit_field(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jff.init_fruit_field(jax.random.PRNGKey(0), jcfg)
    assert sorted(params) == sorted(jparams)
    assert {k: v.shape for k, v in params["base_mlp"].items()} == \
        {k: v.shape for k, v in jparams["base_mlp"].items()}
    with pytest.raises(ValueError, match="encoding"):
        tff.FruitFieldConfig(num_images=1, encoding="octaves")


@pytest.mark.parametrize("contraction", [True, False])
def test_freq_field_forward_and_grads_match_jax(contraction):
    jcfg, tcfg = _field_configs()
    jparams = jax.tree.map(np.asarray, jff.init_fruit_field(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.5, 1.5, (5, 6, 3)).astype(np.float32)
    dirs = rng.normal(size=(5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = np.array([0, 1, 2, 1, 0])
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    tparams = _tree_t(jparams)
    kw = dict(contraction=contraction, aabb=None if contraction else _t(aabb))
    out = tff.fruit_field_forward(tparams, _t(pos), _t(dirs), torch.tensor(cams), tcfg,
                                  train=True, **kw)

    def jfwd(p):
        return jff.fruit_field_forward(p, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(cams),
                                       jcfg, train=True, contraction=contraction,
                                       aabb=None if contraction else jnp.asarray(aabb))

    jout = jfwd(jparams)
    for k in ("density", "rgb", "semantics"):
        _close(out[k], jout[k], atol=ATOL, rtol=1e-4)
    loss = out["density"].sum() + out["rgb"].sum() + out["semantics"].sum()
    loss.backward()
    jg = jax.grad(lambda p: sum(jnp.sum(v) for v in jfwd(p).values()))(jparams)
    for name in ("base_mlp", "color_mlp", "semantic_mlp"):
        for leaf in ("w0", "b0"):
            _grad_close(tparams[name][leaf].grad, jg[name][leaf])


@pytest.fixture(scope="module")
def setup():
    scene = render_scene(SyntheticSceneConfig(
        num_fruits=4, image_size=24, num_cameras=N_CAMS, num_leaves=6))

    def shrink(cfg, dtype):
        m = cfg.model
        model = dataclasses.replace(
            m, num_proposal_samples=(24, 12), num_nerf_samples=8,
            proposal_nets=tuple(dataclasses.replace(p, compute_dtype=dtype)
                                for p in m.proposal_nets),
            field=dataclasses.replace(m.field, hidden_dim=32, hidden_dim_color=32,
                                      hidden_dim_semantic=32, appearance_embed_dim=8))
        return dataclasses.replace(cfg, model=model)

    jcfg = shrink(jconfigs.apply_overrides(
        jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32, variant="tpu"), OVERRIDES),
        jnp.float32)
    tcfg = shrink(configs.apply_overrides(
        configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32, variant="tpu"), OVERRIDES),
        torch.float32)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    return dict(jcfg=jcfg, tcfg=tcfg, jdata=jax_dataset_from_scene(scene),
                tdata=dataset_from_scene(scene, "cpu"), jstate=jstate,
                params0=jax.tree.map(np.array, jstate.params),
                step_fn=jtrainer.make_train_step(jcfg))


def test_tpu_variant_step_matches_jax(setup):
    """Step 0 of the shrunk tpu variant: every loss term and every gradient
    leaf (the field's MLPs, the frequency proposals, appearance, camera)."""
    key = jax.random.PRNGKey(1)
    jnew, jm = setup["step_fn"](setup["jstate"], setup["jdata"], key)
    tcfg = setup["tcfg"]
    tstate = trainer.init_train_state(
        tcfg, N_CAMS, "cpu", params=bridge.params_from_jax(setup["params0"], tcfg.model, "cpu"))
    tm = trainer.train_step(tstate, setup["tdata"], tcfg,
                            draws=_jax_draws(key, 0, setup["jcfg"], setup["jdata"]))
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "total_loss",
              "psnr", "distortion"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_LOSS_RTOL, err_msg=k)
    errors = _grad_errors(jnew, tstate, tcfg.model)
    assert "/model/field/base_mlp/w3" in errors and not any("table" in p for p in errors)
    for path, (rel, _, _) in errors.items():
        assert rel <= STEP_GRAD_RTOL, (path, rel)


def test_tpu_variant_round_trips_the_bridge(setup):
    tcfg = setup["tcfg"]
    params = bridge.params_from_jax(setup["params0"], tcfg.model, "cpu")
    back = bridge.params_to_jax(params, tcfg.model)
    for a, b in zip(bridge.tree_leaves(back), bridge.tree_leaves(setup["params0"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_tpu_run_restores_and_exports(tmp_path):
    """A tpu-variant run through the CLI: its manifest records no table,
    ``load_run`` restores it, and ``export`` streams its field."""
    from test_torch_orchard_e2e import cli

    from fruitnerf_tpu_torch.data.fixture import write_scene_capture
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig as PortScene
    from fruitnerf_tpu_torch.data.synthetic import render_scene as port_render_scene
    from fruitnerf_tpu_torch.engine.checkpoints import read_manifest, table_from_manifest
    from fruitnerf_tpu_torch.engine.runs import load_run

    scene = port_render_scene(PortScene(num_fruits=3, num_cameras=6, image_size=16,
                                        num_leaves=4), device="cpu")
    write_scene_capture(scene, tmp_path / "capture")
    run = tmp_path / "run"
    cli("train", "--preset", "fruit_nerf", "--variant", "tpu", "--data", tmp_path / "capture",
        "--output-dir", run, "--max-iters", 2, "--train-rays-per-batch", 16, "--device", "cpu")
    manifest = read_manifest(run)
    assert manifest["table"] is None and "grid" not in manifest and "hash" not in manifest
    _, config, state = load_run(run, "cpu")
    assert config.model.field.encoding == "freq" and state.step == 2
    assert table_from_manifest(manifest, config.model.field) is None
    with pytest.raises(ValueError, match="has no table.*'grid'"):
        table_from_manifest(manifest, configs.fruit_nerf(6).model.field)
    with pytest.raises(ValueError, match="has no table"):
        table_from_manifest({"grid": {}}, config.model.field)
    cli("export", "--load-dir", run, "--output-dir", tmp_path / "export",
        "--num-points-per-side", 16, "--density-threshold", 0.0,
        "--semantic-logit-threshold", -100, "--colormap-prob-threshold", 0.0, "--device", "cpu")
    assert (tmp_path / "export" / "density.ply").exists()
