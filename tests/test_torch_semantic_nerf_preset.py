"""The port's ``semantic_nerf`` preset (the reference's SemanticNeRFField at
its published widths: an 8 x 256 trunk whose 5th layer takes the encoded
position again, a 256 -> 1 density head, a 283 -> 128 -> 3 colour head, a
256 -> 64 -> 1 semantic branch, 10 / 4 octaves) against the benchmark's
plain reference (``port_bench/reference/semantic_nerf.py``), on the CPU:

* the field at the published widths, in float32 and in bf16: its outputs
  and the gradient of every leaf, the positions' and the directions';
* at ``port_bench/tests/tiny.py``'s shrunk size (its grid and hash shrink
  touch nothing this field computes), one ``train_step`` of the cell's
  configuration on the benchmark's seeded weights and draws: the loss, each
  leaf's gradient and its parameters after RAdam; a whole run of the
  cell's three checked steps reads ``check.numbers``' gaps under the cell's
  limits, and the controls (fp8 operands, half of the rays) do not;
* the preset's widths, its one variant, the twin defaults; ``train``,
  ``eval``, ``render`` and ``export`` on a ``semantic_nerf`` run.

The reference imports no JAX; JAX may be loaded beside it (tier-1's
conftest loads it).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from test_torch_bench_fruit_nerf_parity import (  # noqa: F401
    checked_steps_read_under_the_limits, threads,
)
from test_torch_orchard_e2e import cli

from fruitnerf_tpu_torch import configs
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.data.fixture import write_scene_capture
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.checkpoints import read_manifest
from fruitnerf_tpu_torch.engine.runs import load_run
from fruitnerf_tpu_torch.fields.mlp import MLPConfig
from fruitnerf_tpu_torch.fields.semantic_nerf_field import (
    SemanticNerfFieldConfig,
    init_semantic_nerf_field,
    semantic_nerf_forward,
)
from fruitnerf_tpu_torch.models.fruit_model import forward_export, forward_inference, forward_train
from port_bench import check, control_semantic_nerf, drive, harness, scene as SC
from port_bench import semantic_nerf as SNB
from port_bench.reference import model as RM, semantic_nerf as SN
from port_bench.reference.optim import Optimizer, leaves
from port_bench.tests import tiny

REPO = Path(__file__).resolve().parents[1]
WORKLOAD = "semantic_nerf.tpu.train"
CONFIG = json.loads((REPO / "port_bench" / "configs" / "semantic_nerf.tpu.json").read_text())
LIMITS = json.loads((REPO / "port_bench" / "limits" / f"{WORKLOAD}.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_preset_is_the_published_field():
    cfg = configs.get_preset("semantic_nerf", 200, variant="tpu")
    f, m = cfg.model.field, cfg.model
    assert isinstance(f, SemanticNerfFieldConfig) and cfg.preset == "semantic_nerf"
    assert [(a, b) for a, b in f.base_mlp.layer_dims()] == \
        [(63, 256)] + [(256, 256)] * 3 + [(319, 256)] + [(256, 256)] * 3
    assert f.density_head.layer_dims() == [(256, 1)]
    assert f.color_mlp.layer_dims() == [(283, 128), (128, 3)] and f.color_mlp.out_sigmoid
    assert f.semantic_mlp.layer_dims() == [(256, 64), (64, 1)]
    assert (f.pos_frequencies, f.dir_frequencies, f.scene_contraction, f.density_bias) == \
        (10, 4, True, -3.0)
    assert f.compute_dtype == torch.bfloat16 and f.encoding_config is None
    big = configs.get_preset("fruit_nerf_big", 200, variant="tpu")
    assert (cfg.train_rays_per_batch, m.num_nerf_samples, m.num_proposal_samples,
            m.proposal_nets, m.proposal_weights_anneal_max_num_iters) == \
        (8192, 128, (512, 256), big.model.proposal_nets, 5000)
    assert (cfg.fields_opt, cfg.proposal_opt, cfg.camera_opt, cfg.max_iters,
            cfg.train_split_fraction, cfg.max_train_images) == \
        (big.fields_opt, big.proposal_opt, big.camera_opt, 100000, 0.99, 200)
    assert m.density_sparsity_mult == 0.005
    assert drive.config_diff(cfg, CONFIG["config"]) == []
    for variant in ("grid", "parity"):
        with pytest.raises(KeyError, match="tpu"):
            configs.get_preset("semantic_nerf", 200, variant=variant)


def test_twin_defaults_and_mlp_default_unchanged():
    """The field's defaults stay the JAX twin's; an MLP has no skip unless
    asked for one."""
    f = SemanticNerfFieldConfig()
    assert (f.num_layers_base, f.hidden_dim, f.skip_layers, f.scene_contraction,
            f.density_bias, f.compute_dtype) == (4, 128, (), False, 0.0, torch.float32)
    assert MLPConfig(63, 4, 128, 128).skips == ()
    assert MLPConfig(63, 4, 128, 128).layer_dims() == [(63, 128)] + [(128, 128)] * 3


def _field_case(dtype: str):
    field = dict(CONFIG["config"]["model"]["field"], compute_dtype=dtype)
    cfg = configs.get_preset("semantic_nerf", 4, variant="tpu").model.field
    cfg = dataclasses.replace(cfg, compute_dtype=getattr(torch, dtype))
    params = init_semantic_nerf_field(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    # world positions inside and past the unit cube: the contraction's two branches
    pos = (torch.rand((6, 16, 3), generator=g) * 6.0 - 3.0)
    dirs = torch.nn.functional.normalize(torch.randn((6, 3), generator=g), dim=-1)
    weights = [torch.randn(s, generator=g) for s in ((6, 16), (6, 16, 3), (6, 16, 1))]
    return field, cfg, params, pos, dirs, weights


def _outputs_and_grads(fn, params, pos, dirs, weights):
    leaves_ = [t for _, t in leaves(params)]
    p, d = pos.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    for t in leaves_:
        t.requires_grad_(True)
    outs = fn(params, p, d)
    total = sum((o * w).sum() for o, w in zip(outs, weights))
    grads = torch.autograd.grad(total, [*leaves_, p, d], allow_unused=True)
    return [o.detach() for o in outs], [torch.zeros_like(t) if x is None else x
                                       for t, x in zip([*leaves_, p, d], grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_equals_the_reference(dtype):
    """The port's field against the reference's published joins (the skip
    layer's ``cat([encoding, hidden])``, the colour head's ``cat([trunk,
    direction encoding])``): outputs and every gradient to 1e-5 relative
    and 1e-6 of the largest entry: the same operations on both sides in the
    same dtype, so only float32 sums taken in another order may differ
    (read: equal). The reference on fp8 operands (the ``lower`` control)
    misses that by orders of magnitude."""
    field, cfg, params, pos, dirs, weights = _field_case(dtype)

    def port(p, x, d):
        out = semantic_nerf_forward(p, x, d, cfg)
        return out["density"], out["rgb"], out["semantics"]

    def ref(lower):
        return lambda p, x, d: SN.field_forward(p, x, d, field, lower)

    got_o, got_g = _outputs_and_grads(port, params, pos, dirs, weights)
    want_o, want_g = _outputs_and_grads(ref(False), params, pos, dirs, weights)
    for a, b in zip(got_o + got_g, want_o + want_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    low_o, low_g = _outputs_and_grads(ref(True), params, pos, dirs, weights)
    assert any(not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
               for a, b in zip(low_o + low_g, want_o + want_g))
    assert float(got_o[0].sum()) > 0 and float(got_g[-2].abs().sum()) > 0  # density, d/dpos


def test_one_step_equals_the_reference(root, threads):  # noqa: F811
    """One step from step 10,000 (a step that trains the proposals, camera-opt
    live) at the shrunk size: the loss to 1e-6 relative, each gradient to
    1e-4 relative and 1e-5 of its leaf's largest entry, the parameters after
    RAdam to 1e-5 relative and 1e-7 absolute, as the other cells' one-step
    tests hold them (bf16 products are the same calls on both sides; float32
    sums of other orders differ by ulps)."""
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import draw_step, init_train_state, train_step

    torch.set_num_threads(1)
    cell = harness.cell(WORKLOAD, root)
    cfg = harness.run_config(cell)
    dev = torch.device("cpu")
    (sp,) = drive.scene_params(cell.traffic, 5)
    sc = SC.render(sp, dev)
    n = sp["num_cameras"]
    config = drive.program_config(cell, n, strict=False)
    data = dataset_from_scene(sc, dev, train_fraction=drive.split_of(cfg, cell.traffic))
    step = cell.traffic["start_step"]
    state = init_train_state(config, n, dev, params=SNB.make(cfg, n, 11, dev))
    state.step = step
    metrics = train_step(state, data, config, draws=draw_step(
        config, data, torch.Generator().manual_seed(13)))
    prog = dict(leaves(state.params))

    params = SNB.make(cfg, n, 11, dev)
    rdata = check.ref_data(sc, cfg, cell.traffic, dev)
    rdraws = RM.draw_step(cfg, len(rdata["train_indices"]), sc["images"].shape[1:3],
                          torch.Generator().manual_seed(13), dev)
    lv = leaves(params)
    assert [p for p, _ in lv] == list(prog)
    for _, t in lv:
        t.requires_grad_(True)
    total, _ = SN.loss(params, rdata, cfg, rdraws, step)
    grads = torch.autograd.grad(total, [t for _, t in lv], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(lv, grads)]
    assert float(total.detach()) == pytest.approx(float(metrics["total_loss"]), rel=1e-6)
    for (path, _), g in zip(lv, grads):
        got = prog[path].grad
        got = torch.zeros_like(g) if got is None else got
        torch.testing.assert_close(got, g, rtol=1e-4, atol=1e-5 * float(g.abs().max()), msg=path)
    assert all(float(g.abs().sum()) > 0 for g in grads)  # the step trains every leaf
    Optimizer(cfg).step(lv, grads, step)
    for path, t in lv:
        torch.testing.assert_close(prog[path].detach(), t.detach(), rtol=1e-5, atol=1e-7,
                                   msg=path)


def test_three_checked_steps_read_under_the_limits(root, threads):  # noqa: F811
    """A whole run of the cell at the shrunk size: its three checked steps
    (losses, first gradients, the parameters' change) against the reference
    through ``check.numbers`` read every gap under the cell's limits."""
    checked_steps_read_under_the_limits(root, WORKLOAD, LIMITS)


def test_controls_fail_the_limits(root):
    """The reference on fp8 MLP operands and with half of the rays left out
    each fail a limit of the cell; a frozen state reads 1 on the change."""
    cell = harness.cell(WORKLOAD, root)
    r = control_semantic_nerf.readings(cell, 21, ["lower", "keep_half", "frozen"],
                                       torch.device("cpu"))
    for fault in ("lower", "keep_half"):
        assert not check.verdict(r[fault], LIMITS), (fault, r[fault])
    assert r["frozen"]["change_gap"] == pytest.approx(1.0)


def test_field_spans_nest_in_the_step_stages():
    """An eager step records ``field.trunk`` and ``field.heads`` once each
    inside ``field``, and once each inside ``sparsity`` (the density-only
    path), with tracing on."""
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, train_step
    from fruitnerf_tpu_torch.utils import profiling

    scene = render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=4, image_size=12,
                                              num_leaves=4), device="cpu")
    data = dataset_from_scene(scene, "cpu")
    cfg = configs.get_preset("semantic_nerf", 4, variant="tpu")
    cfg = dataclasses.replace(cfg, train_rays_per_batch=8, model=dataclasses.replace(
        cfg.model, num_nerf_samples=4, num_proposal_samples=(8, 4), sparsity_num_points=16))
    state = init_train_state(cfg, 4, "cpu")
    gen = torch.Generator().manual_seed(0)
    profiling.clear_spans()
    try:
        with profiling.recording():
            train_step(state, data, cfg, gen)
        nested = [(s.name, s.parent) for s in profiling.spans() if s.name.startswith("field.")]
    finally:
        profiling.clear_spans()
    assert nested == [("field.trunk", "field"), ("field.heads", "field"),
                      ("field.trunk", "sparsity"), ("field.heads", "sparsity")]


def test_inference_and_export_forwards_run():
    """The eval forward and the export forward (the box map in place of the
    contraction) on the field, at the published widths."""
    cfg = configs.get_preset("semantic_nerf", 3, variant="tpu")
    from fruitnerf_tpu_torch.engine.trainer import init_train_state

    params = init_train_state(cfg, 3, "cpu").params["model"]
    n = 5
    g = torch.Generator().manual_seed(0)
    bundle = RayBundle(torch.rand((n, 3), generator=g) - 0.5,
                       torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1),
                       torch.full((n,), 0.1), torch.full((n,), 4.0),
                       torch.zeros((n,), dtype=torch.int64))
    with torch.no_grad():
        inf = forward_inference(params, bundle, cfg.model)
        ev = forward_train(params, bundle, cfg.model, None, step=1 << 30, train=False)
        exp = forward_export(params, bundle, cfg.model, 7, torch.tensor([[-1.0] * 3, [1.0] * 3]))
    assert inf["rgb"].shape == (n, 3) and inf["semantics_colormap"].shape == (n, 3)
    torch.testing.assert_close(inf["rgb"], ev["rgb"])
    assert exp["positions"].shape == (n, 7, 3) and exp["density"].shape == (n, 7)
    assert all(bool(torch.isfinite(v).all()) for v in (*inf.values(), *exp.values())
               if isinstance(v, torch.Tensor))
    outside = (exp["positions"].abs() >= 1.0).any(-1)
    assert bool((exp["density"][outside] == 0).all())  # the box's selector


def test_train_eval_render_export_on_a_semantic_nerf_run(tmp_path):
    """``train --preset semantic_nerf --variant tpu`` for two steps of 16
    rays on a capture, then ``eval``, ``render`` and ``export`` of the run:
    the manifest records no table, ``load_run`` rebuilds the preset."""
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=6, image_size=12,
                                              num_leaves=4), device="cpu")
    tree, run = tmp_path / "capture", tmp_path / "run"
    write_scene_capture(scene, tree, eval_fraction=0.34)
    cli("train", "--preset", "semantic_nerf", "--variant", "tpu", "--data", tree,
        "--output-dir", run, "--max-iters", 2, "--train-rays-per-batch", 16, "--device", "cpu")
    m = read_manifest(run)
    assert (m["preset"], m["variant"], m["table"]) == ("semantic_nerf", "tpu", None)
    _, config, state = load_run(run, "cpu")
    assert isinstance(config.model.field, SemanticNerfFieldConfig) and state.step == 2
    cli("eval", "--load-dir", run, "--data", tree, "--output", tmp_path / "eval.json",
        "--device", "cpu")
    assert json.loads((tmp_path / "eval.json").read_text())
    cli("render", "--load-dir", run, "--data", tree, "--output-dir", tmp_path / "render",
        "--cameras", 0, "--device", "cpu")
    assert any((tmp_path / "render").iterdir())
    cli("export", "--load-dir", run, "--output-dir", tmp_path / "export", "--data", tree,
        "--num-points-per-side", 12, "--device", "cpu")
    assert (tmp_path / "export" / "semantic_colormap.ply").exists()
