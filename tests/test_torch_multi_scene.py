"""The port's multi-scene training (fruitnerf_tpu_torch/parallel/multi_scene.py)
against the JAX package's (fruitnerf_tpu/parallel/multi_scene.py): one
``multi_scene_step`` of two scenes on the JAX multi-scene state's parameters
(bridged) and the JAX step's draws (each scene's key is ``fold_in(key,
s)``), on the ``fruit_nerf_smoke`` preset and the grid preset (shrunk as
tests/test_torch_train_step.py shrinks it); against a per-scene loop of the
port's own ``train_step``; scene groups over two devices; the campaign CLI
at the JAX test's arguments; and the grid kernels' autograd Functions under
``torch.func.vmap(grad)`` with their launches stood in for by the plain
version (the kernels run on the card only), which must launch once for all
scenes. Float32 compute on both sides; one torch thread, so that the CPU's
index backward adds in one order."""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (
    FLIP_REL_G, FLIP_SHARE, GRID, OVERRIDES, PARAM_ATOL, _jax_draws, _jax_grads, _leaves, _shrink,
)

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset_from_scene
from fruitnerf_tpu.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu.parallel import multi_scene as jms
from fruitnerf_tpu.scripts import multi_scene_campaign as jcampaign
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
from fruitnerf_tpu_torch.ops import hash_grid as hg
from fruitnerf_tpu_torch.parallel import multi_scene as ms
from fruitnerf_tpu_torch.scripts import multi_scene_campaign

N_CAMS, S = 4, 2
# JAX's own bound between its vmapped step and its per-scene loop
# (tests/test_multi_scene.py:64-70)
LOSS_RTOL = 1e-5
# the port's vmapped step against its own per-scene loop: the same ops on
# the same draws, but a vmapped matmul is a batched matmul, which may sum in
# another order on the CPU. Observed: the smoke preset's losses bitwise; the
# grid preset's interlevel loss (through its frequency-MLP proposal fields)
# 1.4e-7 apart; gradients within 2.4e-7 of each leaf's max.
LOOP_LOSS_RTOL = {"smoke": 0.0, "grid": 1e-6}
LOOP_GRAD_RTOL = 1e-6
# Adam's first step is lr * g / (|g| + 1e-15): below this |g| the step
# depends on |g| itself, so such entries are not compared (as in
# tests/test_torch_hash_train.py)
EPS_REGIME = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(num_scenes=S, size=24):
    """tests/test_multi_scene.py's scenes."""
    return [render_scene(SyntheticSceneConfig(num_fruits=2, num_cameras=N_CAMS, image_size=size,
                                              num_leaves=4, seed=s))
            for s in range(num_scenes)]


def _configs(name):
    """(JAX, port) configs: the JAX test's tiny smoke preset, or the grid
    preset shrunk as in tests/test_torch_train_step.py."""
    if name == "smoke":
        def tiny(cfg):
            m = dataclasses.replace(cfg.model, num_nerf_samples=8, num_proposal_samples=(16, 8))
            return dataclasses.replace(cfg, model=m, train_rays_per_batch=64)
        return tiny(jconfigs.fruit_nerf_smoke(N_CAMS)), tiny(configs.fruit_nerf_smoke(N_CAMS))
    jcfg = _shrink(jconfigs.apply_overrides(
        jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32), OVERRIDES),
        JaxGrid(mode="cell", **GRID), jnp.float32, chunk=100)
    tcfg = _shrink(configs.apply_overrides(
        configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32), OVERRIDES),
        GridEncodingConfig(**GRID), torch.float32, chunk=100)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


@pytest.fixture(scope="module", params=["smoke", "grid"])
def setup(request, scenes):
    jcfg, tcfg = _configs(request.param)
    jdatas = [jax_dataset_from_scene(s, train_fraction=1.0) for s in scenes]
    jstates = jms.init_multi_scene_state(jax.random.PRNGKey(0), jcfg, N_CAMS, S)
    params0 = jax.tree.map(np.array, jstates.params)  # before the step donates them
    key = jax.random.PRNGKey(1)
    jnew, jm = jms.make_multi_scene_step(jcfg)(jstates, jms.stack_datasets(jdatas), key)
    draws = [_jax_draws(jax.random.fold_in(key, s), 0, jcfg, jdatas[s]) for s in range(S)]
    tdatas = [dataset_from_scene(s, "cpu", train_fraction=1.0) for s in scenes]
    state, _ = ms.init_multi_scene_state(
        tcfg, N_CAMS, S, "cpu", params=bridge.scene_params_from_jax(params0, tcfg.model, "cpu"))
    tm = ms.multi_scene_step(state, ms.stack_datasets(tdatas), tcfg, draws=draws)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jnew=jnew, jm=jm, draws=draws,
                params0=params0, tdatas=tdatas, state=state, tm=tm)


def test_multi_scene_step_losses_match_jax(setup):
    jm, tm = setup["jm"], setup["tm"]
    assert tm["total_loss"].shape == (S,)
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "total_loss", "psnr"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    # different scenes -> different losses
    assert float(tm["total_loss"][0]) != float(tm["total_loss"][1])
    assert setup["state"].step == 1 and np.asarray(setup["jnew"].step == 1).all()


def test_multi_scene_post_adam_params_match_jax(setup):
    """Each scene's parameters after the step, at the tolerances of
    tests/test_torch_train_step.py::test_one_step_post_adam_params_match_jax
    (entries whose gradients differ in sign sit at |g| near zero, where
    Adam's first step is a full lr either way)."""
    model = setup["tcfg"].model
    jnew, state = setup["jnew"], setup["state"]
    flips_total = 0
    for s in range(S):
        gj_tree = _jax_grads(jax.tree.map(lambda x, s=s: x[s], jnew.opt_state), model)
        pj = bridge.tree_map(bridge.params_from_jax(
            jax.tree.map(lambda x, s=s: np.asarray(x[s]), jnew.params), model, "cpu"),
            lambda t: t.numpy())
        tparams = bridge.tree_map(state.params, lambda t, s=s: t[s].numpy())
        tgrads = bridge.tree_map(state.params, lambda t, s=s: t.grad[s].numpy())
        for (path, gj, gt), (_, p_j, p_t) in zip(_leaves(gj_tree, tgrads), _leaves(pj, tparams)):
            big = (gj == 0) | (np.abs(gj) > EPS_REGIME)
            same = (np.sign(gj) == np.sign(gt)) & big
            np.testing.assert_allclose(p_t[same], p_j[same], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"scene {s} {path}")
            flips = ~same & big
            flips_total += int(flips.sum())
            assert flips.sum() <= FLIP_SHARE * flips.size, (s, path)
            assert np.all(np.abs(gj[flips]) <= FLIP_REL_G * np.abs(gj).max()), (s, path)
    assert flips_total <= 20


def test_multi_scene_step_matches_a_per_scene_loop(setup):
    """The vmapped step against ``train_step`` of each scene alone on the
    same parameters and draws: losses bitwise on the smoke preset and
    within LOOP_LOSS_RTOL on the grid preset, gradients close."""
    tcfg, tm, state = setup["tcfg"], setup["tm"], setup["state"]
    for s in range(S):
        params = bridge.params_from_jax(
            jax.tree.map(lambda x, s=s: np.asarray(x[s]), setup["params0"]), tcfg.model, "cpu")
        single = trainer.init_train_state(tcfg, N_CAMS, "cpu", params=params)
        m = trainer.train_step(single, setup["tdatas"][s], tcfg, draws=setup["draws"][s])
        for k in ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k][s]), float(m[k]), atol=0,
                                       rtol=LOOP_LOSS_RTOL[setup["name"]], err_msg=f"{s} {k}")
        for a, b in zip(bridge.tree_leaves(state.params), bridge.tree_leaves(single.params)):
            g, ref = a.grad[s], b.grad
            assert float((g - ref).abs().max()) <= LOOP_GRAD_RTOL * max(
                float(ref.abs().max()), 1e-30), s


def test_scene_groups_on_two_devices_equal_one_group(scenes):
    """``devices=["cpu", "cpu"]``: two scene groups, each stepped on its
    device, equal one batched group: the step's metrics bitwise, the
    gradients within LOOP_GRAD_RTOL of each leaf's max (a batched matmul of
    one scene and one of two may round apart)."""
    _, tcfg = _configs("smoke")
    datas = ms.stack_datasets([dataset_from_scene(s, "cpu", train_fraction=1.0) for s in scenes])
    runs = []
    for devices in (None, ["cpu", "cpu"]):
        state, gens = ms.init_multi_scene_state(tcfg, N_CAMS, S, "cpu")
        runs.append((state, ms.multi_scene_step(state, datas, tcfg, gens, devices=devices)))
    (a, ma), (b, mb) = runs
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], atol=0, rtol=0)
    for x, y in zip(bridge.tree_leaves(a.params), bridge.tree_leaves(b.params)):
        assert float((x.grad - y.grad).abs().max()) <= LOOP_GRAD_RTOL * max(
            float(x.grad.abs().max()), 1e-30)


def test_stack_datasets_rejects_mismatched_scenes():
    """The JAX twin's checks and messages."""
    scenes = _scenes(1, size=24) + _scenes(1, size=32)
    jdatas = [jax_dataset_from_scene(s, train_fraction=1.0) for s in scenes]
    tdatas = [dataset_from_scene(s, "cpu", train_fraction=1.0) for s in scenes]
    with pytest.raises(ValueError) as jerr:
        jms.stack_datasets(jdatas)
    with pytest.raises(ValueError, match="identical image stacks") as terr:
        ms.stack_datasets(tdatas)
    assert str(terr.value) == str(jerr.value)
    same = _scenes(2)
    split = [dataset_from_scene(same[0], "cpu", train_fraction=1.0),
             dataset_from_scene(same[1], "cpu", train_fraction=0.5)]
    with pytest.raises(ValueError, match="identical train splits"):
        ms.stack_datasets(split)


def test_scene_params_bridge_round_trips(setup):
    """``bridge.scene_params_to_jax`` inverts ``scene_params_from_jax`` on a
    JAX multi-scene state's parameters."""
    back = bridge.scene_params_to_jax(
        bridge.scene_params_from_jax(setup["params0"], setup["tcfg"].model, "cpu"),
        setup["tcfg"].model)
    for (_, a, b) in _leaves(setup["params0"], back):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_campaign_cli_at_the_jax_tests_arguments(tmp_path):
    """tests/test_multi_scene.py's campaign arguments, on the CPU: the JAX
    report's keys, a row per scene with its ground truth, a directory per
    scene."""
    argv = ["--scenes", "2", "--num-fruits", "3", "--num-cameras", "6",
            "--image-size", "32", "--iters", "15", "--preset", "fruit_nerf_smoke",
            "--export-n", "32", "--train-rays-per-batch", "256",
            "--output-dir", str(tmp_path)]
    jp = argparse.ArgumentParser()
    jcampaign.add_args(jp)
    tp = argparse.ArgumentParser()
    multi_scene_campaign.add_args(tp)
    jargs, targs = jp.parse_args(argv), tp.parse_args([*argv, "--device", "cpu"])
    assert vars(targs) == {**vars(jargs), "device": "cpu"}
    multi_scene_campaign.main(targs)
    report = json.loads((tmp_path / "campaign_report.json").read_text())
    assert {"render_s", "train_s", "train_rays_per_sec_all_scenes", "final_loss_per_scene",
            "final_psnr_per_scene", "scenes", "scenes_exact", "scenes_within_1"} <= set(report)
    assert len(report["scenes"]) == 2
    assert report["scenes"][0]["gt"] == 3 and report["scenes"][1]["gt"] == 4
    assert len(report["final_psnr_per_scene"]) == 2
    assert all(np.isfinite(report["final_loss_per_scene"]))
    assert (tmp_path / "scene_00").is_dir() and (tmp_path / "scene_01").is_dir()


# ---------------------------------------------------------------------------
# the kernels' autograd Functions under torch.func, launches stood in for
# ---------------------------------------------------------------------------


def _stand_ins(monkeypatch, family: str, calls: list):
    """Replace the CUDA launches of ``family`` by the plain version on the
    CPU, taking the kernels' scene axis (S-batched operands, an unbatched
    one shared), and record each launch's scene count."""
    plain = hg.cell_encode_torch if family == "cell" else (
        lambda t, p, layout, f: hg.grid_encode_corner_torch(t, p, layout, f))

    def scenes(*ts):
        return max((t.shape[0] for t in ts if t is not None and t.dim() == 3), default=None)

    def each(t, s):
        return t if t.dim() == 2 else t[s]

    def fwd(table, pos, layout, *f):
        n = scenes(table, pos)
        calls.append(("fwd", n))
        if n is None:
            return plain(table, pos, layout, *f)
        return torch.stack([plain(each(table, s), each(pos, s), layout, *f) for s in range(n)])

    def bwd(table, pos, grad, layout, *rest):
        *f, needs = rest
        n = scenes(table, pos, grad)
        calls.append(("bwd", n, needs))

        def one(t, p, g):
            t = t.detach().requires_grad_(True)
            p = p.detach().requires_grad_(needs)
            with torch.enable_grad():
                got = torch.autograd.grad(plain(t, p, layout, *f), [t, p] if needs else [t], g)
            return got[0], (got[1] if needs else None)

        if n is None:
            return one(table, pos, grad)
        out = [one(each(table, s), each(pos, s), each(grad, s)) for s in range(n)]
        return torch.stack([a for a, _ in out]), (
            torch.stack([b for _, b in out]) if needs else None)

    monkeypatch.setattr(hg, f"{family}_encode_fwd_cuda", fwd)
    monkeypatch.setattr(hg, f"{family}_encode_bwd_cuda", bwd)


@pytest.mark.parametrize("family", ["cell", "corner"])
def test_kernel_functions_launch_once_for_all_scenes_under_vmap(family, monkeypatch):
    """``vmap(grad_and_value(...))`` through ``_CellEncodeCUDA`` /
    ``_CornerEncodeCUDA``: each Function's vmap rule launches once for the
    three scenes (forward and, through the backward Function, backward);
    dPositions only for the positions that need it; the values and
    gradients equal the plain version's under the same transform, and a
    plain autograd backward through the Functions as well."""
    calls = []
    _stand_ins(monkeypatch, family, calls)
    grid = GridEncodingConfig(num_levels=4, table_size=512, base_res=4, max_res=64,
                              mid_table_size=256, fine_levels=2)
    if family == "cell":
        layout, width = grid.cell_layout(), 16
        kernel = lambda t, p: hg._CellEncodeCUDA.apply(t, p, layout)  # noqa: E731
        plain = lambda t, p: hg.cell_encode_torch(t, p, layout)  # noqa: E731
    else:
        layout, width = hg.corner_layout((4, 8, 16, 32), 512), 2
        kernel = lambda t, p: hg._CornerEncodeCUDA.apply(t, p, layout, 2)  # noqa: E731
        plain = lambda t, p: hg.grid_encode_corner_torch(t, p, layout, 2)  # noqa: E731
    g = torch.Generator().manual_seed(0)
    n = 3
    tables = torch.rand((n, layout.total_rows, width), generator=g) - 0.5
    shift = torch.randn((n, 3), generator=g) * 0.01
    pos = torch.rand((n, 50, 3), generator=g) * 0.8 + 0.1
    w = torch.randn((n, 50, 2 * layout.num_levels), generator=g)

    def loss(encode):
        def fn(table, shift, pos, w):
            # the shifted positions need a gradient; the others do not
            return (encode(table, pos + shift) * w).sum() + (encode(table, pos) ** 2).sum()
        return torch.func.vmap(torch.func.grad_and_value(fn, argnums=(0, 1)))

    (gt, gs), value = loss(kernel)(tables, shift, pos, w)
    assert calls == [("fwd", n), ("fwd", n), ("bwd", n, False), ("bwd", n, True)]
    (pt, ps), pvalue = loss(plain)(tables, shift, pos, w)
    for a, b in ((value, pvalue), (gt, pt), (gs, ps)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    calls.clear()  # one scene, plain autograd: unbatched launches
    t0 = tables[0].clone().requires_grad_(True)
    s0 = shift[0].clone().requires_grad_(True)
    ((kernel(t0, pos[0] + s0) * w[0]).sum() + (kernel(t0, pos[0]) ** 2).sum()).backward()
    assert calls == [("fwd", None), ("fwd", None), ("bwd", None, False), ("bwd", None, True)]
    torch.testing.assert_close(t0.grad, pt[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(s0.grad, ps[0], atol=1e-6, rtol=1e-6)
