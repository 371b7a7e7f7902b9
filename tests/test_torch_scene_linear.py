"""The MLP layers' matrix products (``fields/mlp.py:_SceneLinear``).

On the CPU: outside ``torch.func.vmap`` ``apply_mlp`` equals the plain
``h @ w`` MLP bitwise, output and every gradient, at the port's MLP widths;
``vmap(grad_and_value)`` over four scenes through ``apply_mlp`` equals a
loop of single-scene ``grad_and_value`` per scene, with every operand
batched and with the weights or the input shared, and so does plain
autograd through a ``vmap`` of ``apply_mlp``; ``scene_linear_calls``
rises only under the scene rule, and so in ``multi_scene_step`` and not in
``train_step``.

On a card (marked ``gpu``, skipped without one): the single-scene Function
equals autograd's ``h @ w`` in bf16 bitwise, and the scene rule equals the
single-scene products per scene at the campaign's sample counts. This file
imports no JAX, so it runs on the card:

    python -m pytest --noconftest -q tests/test_torch_scene_linear.py
"""
import dataclasses

import pytest
import torch
from torch.func import grad_and_value, vmap

from fruitnerf_tpu_torch.fields import mlp
from fruitnerf_tpu_torch.fields.mlp import MLPConfig, _SceneLinear, apply_mlp, init_mlp

# (in, hidden..., out) of the port's MLPs: the proposal fields' nerf_encode
# inputs (5 and 7 frequencies), the colour MLP's SH + geo + appearance input,
# the semantic MLP's geo features
WIDTHS = [(33, 32, 1), (45, 64, 64, 1), (63, 64, 64, 3), (15, 64, 1)]
WIDTH_IDS = ["33-32-1", "45-64-64-1", "63-64-64-3", "15-64-1"]
SCENES = 4
ROWS = 96
# vmap against the per-scene loop: the rule issues the single-scene products
# (``mm`` on each scene's contiguous operands), so the float32 tolerance is
# zero: the same products in the same order
LOOP_ATOL = 0.0


def _config(widths) -> MLPConfig:
    return MLPConfig(in_dim=widths[0], num_layers=len(widths) - 1, hidden_dim=widths[1],
                     out_dim=widths[-1])


def _params(config, seed, scenes=None) -> dict:
    gen = torch.Generator().manual_seed(seed)
    if scenes is None:
        return init_mlp(config, gen, "cpu")
    inits = [init_mlp(config, gen, "cpu") for _ in range(scenes)]
    return {k: torch.stack([p[k] for p in inits]) for k in inits[0]}


def _plain_mlp(params, x, config, dtype):
    """``apply_mlp`` as it was: ``h @ w`` through autograd's own ``mm``."""
    h = x.reshape(-1, x.shape[-1]).to(dtype)
    for i in range(config.num_layers):
        h = h @ params[f"w{i}"].to(dtype) + params[f"b{i}"].to(dtype)
        if i < config.num_layers - 1:
            h = torch.relu(h)
    return h.float().reshape(*x.shape[:-1], config.out_dim)


def _weighted(out):
    return (out * torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)).square().sum()


def _loss(apply):
    return lambda params, x, config, dtype: _weighted(apply(params, x, config, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("widths", WIDTHS, ids=WIDTH_IDS)
def test_unbatched_mlp_equals_the_plain_matmul_bitwise(widths, dtype):
    """Output, input gradient and every parameter gradient of ``apply_mlp``
    equal the plain ``h @ w`` version's bitwise."""
    config = _config(widths)
    params = _params(config, 1)
    x = torch.randn(2, ROWS // 2, widths[0], generator=torch.Generator().manual_seed(2))
    res = []
    for apply in (apply_mlp, _plain_mlp):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        out = apply(p, xx, config, dtype)
        _weighted(out).backward()
        res.append([out.detach(), xx.grad] + [p[k].grad for k in sorted(p)])
    assert all(torch.equal(a, b) for a, b in zip(*res))


@pytest.mark.parametrize("shared", [None, "weights", "input"])
@pytest.mark.parametrize("widths", WIDTHS, ids=WIDTH_IDS)
def test_vmapped_mlp_equals_a_per_scene_loop(widths, shared):
    """``vmap(grad_and_value)`` over four scenes through ``apply_mlp``, bf16
    products, against single-scene ``grad_and_value`` of each scene: loss,
    parameter and input gradients equal to ``LOOP_ATOL``. ``shared``: that
    operand is unbatched, every scene's."""
    config = _config(widths)
    gen = torch.Generator().manual_seed(3)
    params = _params(config, 4, None if shared == "weights" else SCENES)
    x = torch.randn(*(() if shared == "input" else (SCENES,)), ROWS, widths[0], generator=gen)
    in_dims = (None if shared == "weights" else 0, None if shared == "input" else 0)
    fn = grad_and_value(lambda p, xx: _loss(apply_mlp)(p, xx, config, torch.bfloat16),
                        argnums=(0, 1))
    (gp, gx), value = vmap(fn, in_dims=in_dims)(params, x)
    for s in range(SCENES):
        ps = params if shared == "weights" else {k: v[s] for k, v in params.items()}
        (gps, gxs), vs = fn(ps, x if shared == "input" else x[s])
        torch.testing.assert_close(value[s], vs, atol=LOOP_ATOL, rtol=0)
        torch.testing.assert_close(gx[s], gxs, atol=LOOP_ATOL, rtol=0)
        for k in gps:
            torch.testing.assert_close(gp[k][s], gps[k], atol=LOOP_ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("widths", WIDTHS, ids=WIDTH_IDS)
def test_plain_autograd_through_a_vmapped_mlp_equals_a_per_scene_loop(widths):
    """``vmap`` of ``apply_mlp`` inside plain autograd (leaves that require
    grad, ``backward``): output and gradients equal those of each scene's
    own forward and backward."""
    config = _config(widths)
    params = _params(config, 8, SCENES)
    x = torch.randn(SCENES, ROWS, widths[0], generator=torch.Generator().manual_seed(9))
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    out = vmap(lambda pp, xs: apply_mlp(pp, xs, config, torch.bfloat16))(p, xx)
    sum(_weighted(out[s]) for s in range(SCENES)).backward()
    for s in range(SCENES):
        ps = {k: v[s].clone().requires_grad_() for k, v in params.items()}
        xs = x[s].clone().requires_grad_()
        outs = apply_mlp(ps, xs, config, torch.bfloat16)
        _weighted(outs).backward()
        torch.testing.assert_close(out[s], outs, atol=LOOP_ATOL, rtol=0)
        torch.testing.assert_close(xx.grad[s], xs.grad, atol=LOOP_ATOL, rtol=0)
        for k in ps:
            torch.testing.assert_close(p[k].grad[s], ps[k].grad, atol=LOOP_ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("where", ["unbatched", "vmap"])
def test_scene_linear_calls_count_only_the_scene_rule(where):
    """Outside ``vmap`` a forward and backward issue no scene-batched
    product; under it every layer issues three (its forward, input gradient
    and weight gradient), but the first layer no input gradient where the
    input needs none."""
    config = _config((45, 64, 64, 1))
    before = mlp.scene_linear_calls
    loss = _loss(apply_mlp)
    if where == "unbatched":
        p = {k: v.requires_grad_() for k, v in _params(config, 5).items()}
        loss(p, torch.randn(ROWS, 45), config, torch.bfloat16).backward()
        assert mlp.scene_linear_calls == before
    else:
        fn = grad_and_value(lambda p, xx: loss(p, xx, config, torch.bfloat16))
        vmap(fn)(_params(config, 5, SCENES), torch.randn(SCENES, ROWS, 45))
        assert mlp.scene_linear_calls - before == 3 * config.num_layers - 1


def test_the_multi_scene_step_goes_through_the_scene_rule_and_the_single_step_does_not():
    """One ``train_step`` of the smoke preset issues no scene-batched
    product; one ``multi_scene_step`` of two scenes issues them."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, train_step
    from fruitnerf_tpu_torch.parallel import multi_scene as ms

    scenes = [render_scene(SyntheticSceneConfig(num_fruits=2 + s, num_cameras=4, image_size=16,
                                                num_leaves=2, seed=101 * s), device="cpu")
              for s in range(2)]
    datas = [dataset_from_scene(sc, "cpu", train_fraction=1.0) for sc in scenes]
    cfg = dataclasses.replace(fruit_nerf_smoke(4), train_rays_per_batch=32)
    state = init_train_state(cfg, 4, "cpu", generator=torch.Generator().manual_seed(0))
    before = mlp.scene_linear_calls
    train_step(state, datas[0], cfg, torch.Generator().manual_seed(1))
    assert mlp.scene_linear_calls == before
    mstate, gens = ms.init_multi_scene_state(cfg, 4, 2, "cpu")
    ms.multi_scene_step(mstate, ms.stack_datasets(datas), cfg, gens)
    assert mlp.scene_linear_calls > before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

# the campaign's sample counts a scene: proposal 0 (2048 rays x 256), proposal
# 1 (x 96), the fine field (x 48)
CAMPAIGN_ROWS = [524_288, 196_608, 98_304]
# (in, out) of one layer at each count: the proposals' first layers and the
# fine field's colour MLP input layer, unaligned inputs; a hidden layer
CAMPAIGN_LAYERS = {524_288: [(33, 32), (32, 1)], 196_608: [(45, 64), (64, 64)],
                   98_304: [(63, 64), (15, 64), (64, 3)]}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the products' kernels are cuBLAS's)")
    return torch.device("cuda", 0)


def _bf16(gen, *shape, dev, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [4096, 98_304])
@pytest.mark.parametrize("widths", WIDTHS, ids=WIDTH_IDS)
def test_the_single_scene_function_is_autograds_matmul_on_the_card(card, widths, rows):
    """bf16 ``_SceneLinear`` forward and both gradients against autograd's
    ``h @ w`` on the same operands: bitwise equal."""
    gen = torch.Generator(device=card).manual_seed(6)
    for d_in, d_out in zip(widths[:-1], widths[1:]):
        h = _bf16(gen, rows, d_in, dev=card)
        w = _bf16(gen, d_in, d_out, dev=card, scale=d_in ** -0.5)
        g = _bf16(gen, rows, d_out, dev=card)
        res = []
        for f in (_SceneLinear.apply, torch.matmul):
            hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
            out = f(hh, ww)
            out.backward(g)
            res.append((out.detach(), hh.grad, ww.grad))
        torch.cuda.synchronize(card)
        assert all(torch.equal(a, b) for a, b in zip(*res)), (d_in, d_out)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", CAMPAIGN_ROWS)
def test_the_scene_rule_equals_the_single_scene_products_at_the_campaigns_shapes(card, rows):
    """Four scenes of one layer under ``vmap(vjp)`` at the campaign's sample
    counts against each scene's single-scene ``_SceneLinear``: forward,
    input and weight gradient bitwise equal (the rule issues the same
    ``mm`` a scene), and the rule counted."""
    gen = torch.Generator(device=card).manual_seed(7)
    for d_in, d_out in CAMPAIGN_LAYERS[rows]:
        h = _bf16(gen, SCENES, rows, d_in, dev=card)
        w = _bf16(gen, SCENES, d_in, d_out, dev=card, scale=d_in ** -0.5)
        g = _bf16(gen, SCENES, rows, d_out, dev=card)

        def fwd_bwd(hh, ww, gg):
            out, pull = torch.func.vjp(_SceneLinear.apply, hh, ww)
            return (out, *pull(gg))

        before = mlp.scene_linear_calls
        batched = vmap(fwd_bwd)(h, w, g)
        assert mlp.scene_linear_calls - before == 3
        for s in range(SCENES):
            single = fwd_bwd(h[s], w[s], g[s])
            torch.cuda.synchronize(card)
            for name, a, b in zip(("out", "dh", "dw"), batched, single):
                assert torch.equal(a[s], b), (d_in, d_out, s, name)
