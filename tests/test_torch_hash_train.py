"""One train step of the port's hash-grid models against the JAX package's,
on the same parameters (bridged) and the same draws (the JAX step's,
injected), as tests/test_torch_train_step.py does for the grid preset: the
``fruit_nerf_smoke`` preset (an 8-level hash field, two 4-level hash
proposal fields) and the ``parity`` variant of ``fruit_nerf`` (a 16-level
2^19-entry corner hash field, two 5-level 2^17-entry proposal fields; rays
and samples shrunk, the table shapes kept). Losses, every gradient leaf at
step 0, and the parameters after Adam; float32 compute on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (
    FLIP_REL_G, FLIP_SHARE, LOSS_RTOL, N_CAMS, OVERRIDES, PARAM_ATOL, _grad_errors, _jax_draws,
    _jax_grads, _leaves,
)

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import trainer

SHRINK = dict(num_proposal_samples=(24, 12), num_nerf_samples=8)  # the parity variant's samples
# Step-0 gradients, per leaf, relative to its max |g|. The hash levels reach
# res 128 (smoke) and 2048 (parity), so a float32 ulp in a sample's position
# moves it across a cell face: nudging the port's own sampler draws by one
# ulp moves its gradients by up to 5.9e-4 of their max (the parity table).
# Observed against JAX: <= 1.5e-3 (smoke proposal 0's output bias), 9.6e-4
# (the parity table).
HASH_GRAD_RTOL = 3e-3
# The gated step (anneal 1): as in tests/test_torch_train_step.py the table
# and the base MLP differ by up to 19% (parity) and are left out; the rest
# observed <= 2.9e-3 (the parity camera_opt, which reads every level's dPos).
HASH_GATED_RTOL = 1e-2
# Adam's first step is lr * g / (|g| + 1e-15): below this |g| the step
# depends on |g| itself (the base MLP's rows that read the 1e-4 table
# entries sit there), so such entries are not compared.
EPS_REGIME = 1e-9
TABLES = ("/model/field/hash_table", "/model/proposal_networks/0/hash_table",
          "/model/proposal_networks/1/hash_table")


def _configs(name):
    if name == "smoke":
        jcfg = jconfigs.fruit_nerf_smoke(N_CAMS)
        tcfg = configs.fruit_nerf_smoke(N_CAMS)
    else:
        jcfg = jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32, variant="parity")
        tcfg = configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32, variant="parity")
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, **SHRINK))
        tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, **SHRINK))
    return jconfigs.apply_overrides(jcfg, OVERRIDES), configs.apply_overrides(tcfg, OVERRIDES)


@pytest.fixture(scope="module")
def scene():
    return render_scene(SyntheticSceneConfig(
        num_fruits=4, image_size=24, num_cameras=N_CAMS, num_leaves=6))


@pytest.fixture(scope="module", params=["smoke", "parity"])
def setup(request, scene):
    jcfg, tcfg = _configs(request.param)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    return dict(
        name=request.param, jcfg=jcfg, tcfg=tcfg, jdata=jax_dataset_from_scene(scene),
        tdata=dataset_from_scene(scene, "cpu"), jstate=jstate,
        params0=jax.tree.map(np.array, jstate.params), step_fn=jtrainer.make_train_step(jcfg),
    )


def _one_step(setup, step):
    key = jax.random.PRNGKey(1)
    jstate = jax.tree.map(jnp.array, setup["jstate"]).replace(step=jnp.asarray(step, jnp.int32))
    jnew, jm = setup["step_fn"](jstate, setup["jdata"], key)
    tcfg = setup["tcfg"]
    tstate = trainer.init_train_state(
        tcfg, N_CAMS, "cpu", params=bridge.params_from_jax(setup["params0"], tcfg.model, "cpu"))
    tstate.step = step
    tm = trainer.train_step(tstate, setup["tdata"], tcfg,
                            draws=_jax_draws(key, step, setup["jcfg"], setup["jdata"]))
    # each term to LOSS_RTOL of itself or of the total: at step 0 the
    # interlevel term is ~4e-7, where float32 rounding alone is 2e-5 of it
    atol = LOSS_RTOL * float(jm["total_loss"])
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "total_loss",
              "psnr", "distortion"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=atol,
                                   err_msg=k)
    return jnew, tstate


def test_config_matches_jax(setup):
    """The port's preset (or variant) equals the JAX package's field for
    field, its hash tables' shapes included."""
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    assert tcfg.model.field.encoding == jcfg.model.field.encoding == "hash"
    for t, j in zip((tcfg.model.field.hash, *(p.hash for p in tcfg.model.proposal_nets)),
                    (jcfg.model.field.hash, *(p.hash for p in jcfg.model.proposal_nets))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for f in ("num_nerf_samples", "num_proposal_samples", "near_plane", "far_plane",
              "background_color", "proposal_weights_anneal_max_num_iters", "proposal_warmup"):
        assert getattr(tcfg.model, f) == getattr(jcfg.model, f), f
    for f in ("max_iters", "train_rays_per_batch", "eval_rays_per_chunk", "steps_per_save",
              "steps_per_eval"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for group in ("fields_opt", "proposal_opt", "appearance_opt", "camera_opt"):
        t, j = getattr(tcfg, group), getattr(jcfg, group)
        assert (t.lr_init, t.lr_final, t.eps, t.warmup_steps, t.weight_decay) == \
            (j.lr_init, j.lr_final, j.eps, j.warmup_steps, j.weight_decay), group
    tparams = bridge.params_from_jax(setup["params0"], tcfg.model, "cpu")
    assert tparams["model"]["field"]["hash_table"].shape == tcfg.model.field.hash.table_shape


def test_first_step_losses_and_grads_match_jax(setup):
    """Step 0: every loss term and every gradient leaf, the three hash
    tables included."""
    jnew, tstate = _one_step(setup, 0)
    errors = _grad_errors(jnew, tstate, setup["tcfg"].model)
    assert set(TABLES) <= set(errors)
    for path, (rel, _, _) in errors.items():
        assert rel <= HASH_GRAD_RTOL, (path, rel)


def test_gated_step_matches_jax(setup):
    """At step 2001 the proposal fields are gated off (they train every 5th
    step after the warmup): zero proposal gradients on both sides; the rest
    at HASH_GATED_RTOL, the cell-sensitive leaves left out."""
    jnew, tstate = _one_step(setup, 2001)
    for path, (rel, gj, gt) in _grad_errors(jnew, tstate, setup["tcfg"].model).items():
        if path.startswith("/model/proposal_networks"):
            assert not gt.any() and not gj.any(), path
        elif not path.startswith(("/model/field/hash_table", "/model/field/base_mlp/")):
            assert rel <= HASH_GATED_RTOL, (path, rel)


def test_one_step_post_adam_params_match_jax(setup):
    jnew, tstate = _one_step(setup, 0)
    model = setup["tcfg"].model
    gj_tree = _jax_grads(jnew.opt_state, model)
    pj = bridge.tree_map(
        bridge.params_from_jax(jax.tree.map(np.asarray, jnew.params), model, "cpu"),
        lambda t: t.numpy())
    tparams = bridge.tree_map(tstate.params, lambda t: t.detach().numpy())
    tgrads = bridge.tree_map(tstate.params, lambda t: t.grad.numpy())
    flips_total = 0
    for (path, gj, gt), (_, p_j, p_t) in zip(_leaves(gj_tree, tgrads), _leaves(pj, tparams)):
        big = (gj == 0) | (np.abs(gj) > EPS_REGIME)
        same = (np.sign(gj) == np.sign(gt)) & big
        np.testing.assert_allclose(p_t[same], p_j[same], atol=PARAM_ATOL, rtol=0, err_msg=path)
        flips = ~same & big
        flips_total += int(flips.sum())
        assert flips.sum() <= FLIP_SHARE * flips.size, path
        assert np.all(np.abs(gj[flips]) <= FLIP_REL_G * np.abs(gj).max()), path
    assert flips_total <= 200  # observed 86 on the parity variant, none on the smoke preset


@pytest.mark.parametrize("variant", ["grid", "parity"])
def test_preset_variant_encoding_routing(variant):
    """tests/test_configs_presets.py:18-29 on the port's ported variants:
    each resolves to the JAX package's encoding; the grid variant's levels
    cap at its table size, the parity variant's proposals are hash fields
    with the JAX package's layouts."""
    cfg = configs.get_preset("fruit_nerf", 4, variant=variant)
    jcfg = jconfigs.get_preset("fruit_nerf", num_images=4, variant=variant)
    expected = {"grid": "grid", "parity": "hash"}[variant]
    assert cfg.model.field.encoding == jcfg.model.field.encoding == expected
    if variant == "grid":
        layout = cfg.model.field.grid.level_layout()
        assert max(t for t, _, _, _ in layout) == cfg.model.field.grid.table_size
        return
    assert dataclasses.asdict(cfg.model.field.hash) == dataclasses.asdict(jcfg.model.field.hash)
    for t, j in zip(cfg.model.proposal_nets, jcfg.model.proposal_nets, strict=True):
        assert dataclasses.asdict(t.hash) == dataclasses.asdict(j.hash)
        assert (t.num_layers, t.hidden_dim, t.use_linear) == (j.num_layers, j.hidden_dim,
                                                              j.use_linear)
