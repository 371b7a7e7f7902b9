"""One train step of the port (fruitnerf_tpu_torch/engine/trainer.py) against
the JAX package's fused step, on the same parameters (bridged) and the same
random draws: the JAX step's draws are reproduced from its key
(trainer.py:223-244, samplers.py:103-109,145-149,202-206) and injected into
the port. Also the optimizer schedules, the chunked eval render, and a
subprocess proving the port runs without JAX. Float32 compute on both sides;
the JAX grid runs its Pallas kernels in interpret mode."""
import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig

LOSS_RTOL = 1e-5  # float32 losses over 64 rays; observed <= 2e-6
GRAD_RTOL = 1e-4  # per leaf, relative to its max |g|; observed <= 4e-5
# After one Adam step from zero moments an entry moves by ~lr*sign(g); where
# both gradients agree in sign the new parameters agree to this (observed
# <= 4e-7 on updates of 1e-3..1e-2).
PARAM_ATOL = 1e-6
# Sign flips (eps 1e-15 makes a near-zero gradient step by a full lr): at
# most this share of a leaf's entries, and only where |g| is this small
# relative to the leaf's max. Observed: none.
FLIP_SHARE = 1e-3
FLIP_REL_G = 1e-3
# eval render, float32; the fine bins follow the proposal weights (anneal 1),
# so depths move with them as in the gated step (observed <= 2e-4 relative)
RENDER_ATOL = 1e-4
RENDER_RTOL = 1e-3
TRACK_RTOL = 1e-4  # per-step total loss over ten steps

GRID = dict(num_levels=4, table_size=512, base_res=4, max_res=64,
            mid_table_size=256, fine_levels=2)
OVERRIDES = {"sparsity_loss": 0.005, "sparsity_points": 64, "train_rays_per_batch": 64}
N_CAMS = 6


def _shrink(cfg, grid, dtype, chunk):
    m = cfg.model
    model = dataclasses.replace(
        m, num_proposal_samples=(24, 12), num_nerf_samples=8,
        proposal_nets=tuple(dataclasses.replace(p, compute_dtype=dtype) for p in m.proposal_nets),
        field=dataclasses.replace(m.field, grid=grid, hidden_dim=32, hidden_dim_color=32,
                                  hidden_dim_semantic=32, appearance_embed_dim=8),
    )
    return dataclasses.replace(cfg, model=model, eval_rays_per_chunk=chunk)


@pytest.fixture(scope="module")
def setup():
    scene = render_scene(SyntheticSceneConfig(
        num_fruits=4, image_size=24, num_cameras=N_CAMS, num_leaves=6))
    jcfg = _shrink(
        jconfigs.apply_overrides(jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32), OVERRIDES),
        JaxGrid(mode="cell", **GRID), jnp.float32, chunk=100,
    )
    tcfg = _shrink(
        configs.apply_overrides(configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32), OVERRIDES),
        GridEncodingConfig(**GRID), torch.float32, chunk=100,
    )
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, N_CAMS)
    return dict(
        scene=scene, jcfg=jcfg, tcfg=tcfg, jdata=jax_dataset_from_scene(scene),
        tdata=dataset_from_scene(scene, "cpu"), jstate=jstate,
        params0=jax.tree.map(np.array, jstate.params),
        step_fn=jtrainer.make_train_step(jcfg),
    )


def _jax_draws(key, step, cfg, data) -> trainer.StepDraws:
    """The JAX step's draws, from its key, as the port's StepDraws."""
    r, mc = cfg.train_rays_per_batch, cfg.model
    h, w = data.image_shape
    k_img, k_y, k_x, k_samp, k_sparse, k_jit = jax.random.split(jax.random.fold_in(key, step), 6)
    stages = jax.random.split(k_samp, len(mc.proposal_nets) + 1)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a)).to(dtype)

    return trainer.StepDraws(
        slot=t(jax.random.randint(k_img, (r,), 0, data.train_indices.shape[0]), torch.int64),
        py=t(jax.random.randint(k_y, (r,), 0, h), torch.int64),
        px=t(jax.random.randint(k_x, (r,), 0, w), torch.int64),
        jitter=t(jax.random.uniform(k_jit, (2, r), minval=-0.5, maxval=0.5)),
        sampler=[t(jax.random.uniform(k, (r, 1))) for k in stages],
        sparse_points=t(jax.random.uniform(
            k_sparse, (mc.sparsity_num_points, 3),
            minval=-mc.sparsity_extent, maxval=mc.sparsity_extent)),
    )


def _jax_grads(opt_state, model):
    """After one step from zero moments Adam's mu is (1 - b1) * g: recover
    the JAX gradients from the per-group Adam states, in the port's layout
    (``model``: the port's FruitModelConfig)."""
    adam = [s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]

    def pick(*xs):
        (a,) = [x for x in xs if not isinstance(x, optax.MaskedNode)]
        return np.asarray(a) / np.float32(0.1)

    g = jax.tree.map(pick, *adam, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return bridge.tree_map(bridge.params_from_jax(g, model, "cpu"), lambda t: t.numpy())


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), b


def _one_step(setup, step):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    key = jax.random.PRNGKey(1)
    jstate = jax.tree.map(jnp.array, setup["jstate"]).replace(step=jnp.asarray(step, jnp.int32))
    jnew, jmetrics = setup["step_fn"](jstate, setup["jdata"], key)
    tstate = trainer.init_train_state(
        tcfg, N_CAMS, "cpu", params=bridge.params_from_jax(setup["params0"], tcfg.model, "cpu"))
    tstate.step = step
    tmetrics = trainer.train_step(
        tstate, setup["tdata"], tcfg, draws=_jax_draws(key, step, jcfg, setup["jdata"]))
    return jnew, jmetrics, tstate, tmetrics


def _grad_errors(jnew, tstate, model):
    """{leaf path: (max |g_port - g_jax| / max |g_jax|, g_jax, g_port)};
    ``model``: the port's FruitModelConfig."""
    tgrads = bridge.tree_map(tstate.params, lambda t: t.grad.numpy())
    return {
        path: (np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-30), gj, gt)
        for path, gj, gt in _leaves(_jax_grads(jnew.opt_state, model), tgrads)
    }


def _assert_losses_close(jm, tm):
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss",
              "total_loss", "psnr", "distortion"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)


def test_first_step_losses_and_grads_match_jax(setup):
    """Step 0: anneal 0 makes the proposal resampling uniform, so both sides
    place the fine samples alike; every gradient leaf is compared."""
    jnew, jm, tstate, tm = _one_step(setup, 0)
    _assert_losses_close(jm, tm)
    for path, (rel, _, _) in _grad_errors(jnew, tstate, setup["tcfg"].model).items():
        assert rel <= GRAD_RTOL, (path, rel)


# Step 2001: the anneal is 1, so the fine samples follow the proposal
# weights. float32 differences of the proposal MLP's high-frequency encoding
# (1e-4 in the level-1 weights) move the resampled fine bins by up to 1e-4 in
# s, and a few samples into other grid cells: the grid table's and the base
# MLP's gradients then differ by up to 15% of their max (measured), with the
# losses equal to 2e-7. Those two are compared at step 0 only; here the
# rest, at this tolerance (observed <= 4e-4):
GATED_GRAD_RTOL = 1e-3
CELL_SENSITIVE = ("/model/field/grid_table", "/model/field/base_mlp/")


def test_gated_step_matches_jax(setup):
    """By step 2001 the proposal nets train every 2nd step: at this odd step
    they are gated off, and their gradients are zero on both sides."""
    jnew, jm, tstate, tm = _one_step(setup, 2001)
    _assert_losses_close(jm, tm)
    errors = _grad_errors(jnew, tstate, setup["tcfg"].model)
    for path, (rel, gj, gt) in errors.items():
        if path.startswith("/model/proposal_networks"):
            assert not gt.any() and not gj.any(), path
        elif not path.startswith(CELL_SENSITIVE):
            assert rel <= GATED_GRAD_RTOL, (path, rel)


def test_one_step_post_adam_params_match_jax(setup):
    jnew, _, tstate, _ = _one_step(setup, 0)
    model = setup["tcfg"].model
    gj_tree = _jax_grads(jnew.opt_state, model)
    pj = bridge.tree_map(
        bridge.params_from_jax(jax.tree.map(np.asarray, jnew.params), model, "cpu"),
        lambda t: t.numpy())
    tparams = bridge.tree_map(tstate.params, lambda t: t.detach().numpy())
    tgrads = bridge.tree_map(tstate.params, lambda t: t.grad.numpy())
    flips_total = 0
    for (path, gj, gt), (_, p_j, p_t) in zip(
        _leaves(gj_tree, tgrads), _leaves(pj, tparams)
    ):
        same = np.sign(gj) == np.sign(gt)
        np.testing.assert_allclose(p_t[same], p_j[same], atol=PARAM_ATOL, rtol=0, err_msg=path)
        flips = ~same
        flips_total += int(flips.sum())
        assert flips.sum() <= FLIP_SHARE * flips.size, path
        assert np.all(np.abs(gj[flips]) <= FLIP_REL_G * np.abs(gj).max()), path
    assert flips_total <= 10


def test_ten_steps_track_jax(setup):
    """Ten consecutive steps from the same parameters, each with the JAX
    step's draws: Adam's moments, bias corrections and the schedules carry
    across steps. The losses agree to this (observed <= 2e-5 over 10 steps;
    past ~30 steps float32 differences compound)."""
    key = jax.random.PRNGKey(1)
    jstate = jax.tree.map(jnp.array, setup["jstate"])
    tcfg = setup["tcfg"]
    tstate = trainer.init_train_state(
        tcfg, N_CAMS, "cpu", params=bridge.params_from_jax(setup["params0"], tcfg.model, "cpu"))
    for step in range(10):
        jstate, jm = setup["step_fn"](jstate, setup["jdata"], key)
        tm = trainer.train_step(tstate, setup["tdata"], tcfg,
                                draws=_jax_draws(key, step, setup["jcfg"], setup["jdata"]))
        np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]),
                                   rtol=TRACK_RTOL, err_msg=f"step {step}")
    assert tstate.step == int(jstate.step) == 10


@pytest.mark.parametrize("group", ["fields", "proposal", "appearance", "camera"])
def test_learning_rates_match_optax(group):
    cfg = configs.fruit_nerf(3)
    opt = {"fields": cfg.fields_opt, "proposal": cfg.proposal_opt,
           "appearance": cfg.appearance_opt, "camera": cfg.camera_opt}[group]
    sched = optax.exponential_decay(opt.lr_init, cfg.max_iters, opt.lr_final / opt.lr_init)
    if opt.warmup_steps:
        sched = optax.join_schedules([optax.constant_schedule(0.0), sched], [opt.warmup_steps])
    for step in (0, 1, 2499, 2500, 2501, 10000, 29999):
        np.testing.assert_allclose(
            trainer.learning_rate(opt, step, cfg.max_iters), float(sched(step)), rtol=1e-6,
            err_msg=str(step))


@pytest.mark.parametrize("warmup", [0, 30], ids=["no_warmup", "warmup"])
def test_learning_rate_decays_over_max_steps(warmup):
    """An optimizer group's ``max_steps`` replaces the run's ``max_iters``
    as the decay horizon, as ``_make_group_tx`` builds it."""
    opt = configs.OptimizerConfig(lr_init=1e-2, lr_final=1e-4, max_steps=100,
                                  warmup_steps=warmup)
    sched = optax.exponential_decay(opt.lr_init, opt.max_steps, opt.lr_final / opt.lr_init)
    if warmup:
        sched = optax.join_schedules([optax.constant_schedule(0.0), sched], [warmup])
    for step in (0, 50, 99, 100, 400):
        np.testing.assert_allclose(
            trainer.learning_rate(opt, step, 1000), float(sched(step)), rtol=1e-6,
            err_msg=str(step))


def test_render_camera_matches_jax(setup):
    """Eval render of a 24x24 camera in chunks of 100 rays (the last chunk
    ragged), mean appearance embedding, on the same parameters."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jout = jtrainer.render_camera(
        jax.tree.map(jnp.asarray, setup["params0"]), setup["jdata"].cameras, 2, jcfg)
    tparams = bridge.params_from_jax(setup["params0"], tcfg.model, "cpu")
    tout = trainer.render_camera(tparams, setup["tdata"].cameras, 2, tcfg)
    for k in ("rgb", "accumulation", "depth", "semantics"):
        assert tout[k].shape == jout[k].shape, k
        atol = RENDER_ATOL * max(1.0, float(np.abs(np.asarray(jout[k])).max()))
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=atol,
                                   rtol=RENDER_RTOL, err_msg=k)
    assert torch.isfinite(tout["rgb"]).all()


def test_port_trains_without_jax():
    """Import every module of the port and take a small train step, a
    render and a two-step corner-mode train_loop with a writer, an eval and
    a checkpoint in a fresh interpreter: jax, flax and optax stay
    unimported."""
    code = textwrap.dedent("""
        import dataclasses, importlib, pkgutil, sys
        import torch
        import fruitnerf_tpu_torch
        for m in pkgutil.walk_packages(fruitnerf_tpu_torch.__path__, "fruitnerf_tpu_torch."):
            importlib.import_module(m.name)
        from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf
        from fruitnerf_tpu_torch.data.builder import (
            SyntheticSceneConfig, dataset_from_scene, render_scene)
        from fruitnerf_tpu_torch.engine.trainer import (
            init_train_state, render_camera, train_step)
        from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
        scene = render_scene(SyntheticSceneConfig(image_size=16, num_cameras=4, num_leaves=4))
        data = dataset_from_scene(scene, "cpu")
        cfg = apply_overrides(fruit_nerf(4), {"sparsity_loss": 0.005, "sparsity_points": 32,
                                              "train_rays_per_batch": 32})
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, num_proposal_samples=(16, 8), num_nerf_samples=8,
            field=dataclasses.replace(m.field, grid=GridEncodingConfig(
                num_levels=3, table_size=256, base_res=4, max_res=32))))
        state = init_train_state(cfg, 4, "cpu")
        metrics = train_step(state, data, cfg, torch.Generator().manual_seed(0))
        assert torch.isfinite(metrics["total_loss"]), metrics
        assert render_camera(state.params, data.cameras, 0, cfg)["rgb"].shape == (16, 16, 3)
        # the corner-mode grid through train_loop, with a writer and checkpoints
        import tempfile
        from fruitnerf_tpu.utils.writer import MetricWriter
        from fruitnerf_tpu_torch.engine.trainer import train_loop
        grid = dataclasses.replace(cfg.model.field.grid, mode="corner")
        cfg = dataclasses.replace(cfg, max_iters=2, steps_per_eval=2, steps_per_save=2,
                                  model=dataclasses.replace(cfg.model, field=dataclasses.replace(
                                      cfg.model.field, grid=grid)))
        with tempfile.TemporaryDirectory() as d:
            writer = MetricWriter(d + "/metrics.jsonl", also_print=False)
            state = train_loop(cfg, data, eval_indices=[3], writer=writer,
                               checkpoint_dir=d + "/ckpt")
            writer.close()
        assert state.step == 2
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        print("FORBIDDEN", bad)
        assert not bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
