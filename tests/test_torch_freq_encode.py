"""The frequency encoding ``nerf_encode`` (``ops/freq_encode.py``: the plain
composition, its closed-form backward, and the CUDA kernel pair
``csrc/freq_encode.cu`` behind two autograd Functions).

On the CPU: the plain encoding written in bf16 is the bf16 cast of the
float32 one, bitwise, output and gradient, at the octaves the presets run
(5, 7, 12, 14); the fields that pass their compute dtype give the bits and
gradients they gave when ``apply_mlp`` cast the float32 encoding; the
closed-form backward matches autograd of the plain version (to the CPU's
own octave-sum order) and sums in the order it emulates; the octave
frequencies are float32(pi) * 2^k, the kernel's; a CPU tensor never touches
the library; the kernels' wrappers refuse dims, octaves and dtypes outside
what the kernels take before they touch it; the Functions, their launches
stood in for by the plain versions, equal the plain encoding, their ``vmap``
rules equal a per-scene loop (also under ``vmap(grad_and_value(...))``), and
a train step counts the launches the card's step makes: four forwards (the
fine samples, the sparsity points, two proposal fields) and the fine
samples' backward on the big frequency network, two forwards on the grid
network, each proposal field's backward on the steps that train them, none
on the base parity network; the multi-scene step launches once for all its
scenes.

On a card (marked ``gpu``, skipped without one): the forward is the plain
composition bitwise in float32 and bf16 at the main path's shapes, and
the backward the closed form and autograd of the plain composition
bitwise (ATen's CUDA octave-sum order); the ``vmap`` rules equal S single launches
bitwise, also under ``vmap(grad_and_value(...))``; the launch counter rises
on a big tpu step and a grid step and stays 0 on a base parity step. This
file imports no JAX, so it runs on the card:

    python -m pytest --noconftest -q tests/test_torch_freq_encode.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from fruitnerf_tpu_torch.configs import apply_overrides, get_preset
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.trainer import draw_step, init_train_state, train_step
from fruitnerf_tpu_torch.fields import encodings
from fruitnerf_tpu_torch.fields.encodings import nerf_encode
from fruitnerf_tpu_torch.fields.freq_density_field import (
    FreqDensityFieldConfig, freq_density_field_forward, init_freq_density_field,
)
from fruitnerf_tpu_torch.fields.fruit_field import FruitFieldConfig, get_density, init_fruit_field
from fruitnerf_tpu_torch.fields.mlp import apply_mlp
from fruitnerf_tpu_torch.models.fruit_model import proposal_updated
from fruitnerf_tpu_torch.ops import freq_encode as fe
from fruitnerf_tpu_torch.ops import hash_grid as hg
from fruitnerf_tpu_torch.parallel import multi_scene as ms

OCTAVES = [5, 7, 12, 14]
# The closed-form backward against autograd of the plain composition on the
# CPU: the same products, but the CPU's sum takes the F octave terms in its
# own order and the closed form in ATen's CUDA order (on the card the two
# are equal bitwise). The terms reach pi 2^(F-1) |g|, so the two sums part by
# a few float32 ulps of that, relative to the largest |dx| of the tensor.
BWD_RTOL = 1e-5
SCENES = 4


def _x(shape, seed, dev="cpu"):
    """Inputs in [-1, 1], as the fields' ``pos01 * 2 - 1``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0


def _g(shape, seed, dtype, dev="cpu"):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _width(dims, octaves):
    return dims * (1 + 2 * octaves)


@pytest.mark.parametrize("octaves", OCTAVES)
def test_the_plain_encoding_in_bf16_is_the_cast_of_the_float32_one(octaves):
    x = _x((2, 300, 3), octaves)
    g = _g((2, 300, _width(3, octaves)), 1, torch.bfloat16)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = nerf_encode(a, octaves, torch.bfloat16)
    ref = nerf_encode(b, octaves).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    out.backward(g)
    ref.backward(g)
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(nerf_encode(x, octaves), nerf_encode(x, octaves, torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("field", ["proposal", "main"])
def test_the_fields_give_the_bits_of_the_cast_in_apply_mlp(field, dtype):
    """The two callers on the step pass their compute dtype: density and
    every gradient equal those of the float32 encoding cast by
    ``apply_mlp``, bitwise."""
    gen = torch.Generator().manual_seed(3)
    pos = (torch.rand((64, 7, 3), generator=gen) * 4.0 - 2.0).requires_grad_(True)
    if field == "proposal":
        cfg = FreqDensityFieldConfig(num_frequencies=7, num_layers=3, hidden_dim=64,
                                     compute_dtype=dtype)
        params = init_freq_density_field(cfg, gen, "cpu")

        def new(p, x):
            return freq_density_field_forward(p, x, cfg)

        def old(p, x):
            from fruitnerf_tpu_torch.core.math import contract_to_unit, trunc_exp

            pos01, selector = contract_to_unit(x)
            enc = fe.freq_encode_torch(pos01 * 2.0 - 1.0, cfg.num_frequencies)
            return trunc_exp(apply_mlp(p["mlp"], enc, cfg.mlp, dtype)[..., 0]) * selector
    else:
        cfg = FruitFieldConfig(num_images=3, encoding="freq", pos_frequencies=14,
                               hidden_dim=128, compute_dtype=dtype)
        params = init_fruit_field(cfg, gen, "cpu")

        def new(p, x):
            density, geo = get_density(p, x, cfg)
            return density + geo.sum(-1)

        def old(p, x):
            from fruitnerf_tpu_torch.core.math import contract_to_unit, trunc_exp

            pos01, selector = contract_to_unit(x)
            h = fe.freq_encode_torch(pos01 * 2.0 - 1.0, cfg.pos_frequencies)
            out = apply_mlp(p["base_mlp"], h, cfg.base_mlp, dtype)
            return trunc_exp(out[..., 0] + cfg.density_bias) * selector + out[..., 1:].sum(-1)
    mlp = params["mlp"] if field == "proposal" else params["base_mlp"]
    leaves = [pos] + [t.requires_grad_(True) for t in mlp.values()]
    res = []
    for fn in (new, old):
        out = fn(params, pos)
        res.append((out.detach(), torch.autograd.grad(out.square().sum(), leaves,
                                                      allow_unused=True)))
    assert torch.equal(res[0][0], res[1][0])
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(res[0][1], res[1][1]))


@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("octaves", OCTAVES)
def test_the_closed_form_backward_matches_autograd_of_the_plain_version(octaves, gdtype):
    x = _x((1000, 3), 10 + octaves)
    g = _g((1000, _width(3, octaves)), 2, gdtype)
    a = x.clone().requires_grad_(True)
    fe.freq_encode_torch(a, octaves, gdtype).backward(g)
    dx = fe.freq_encode_bwd_torch(x, g, octaves)
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    assert _rel(dx, a.grad) <= BWD_RTOL


@pytest.mark.parametrize("octaves", list(range(1, 17)))
def test_the_octave_sum_walks_a_halving_tree_over_strided_lanes(octaves):
    """``_octave_sum`` in ATen's CUDA order, written out another way: lane l
    of B = 2^floor(log2 F) holds u_l + u_{l+B}, then lanes l and l + h meet
    for h = B/2, B/4, ..., 1: equal bitwise."""
    u = torch.randn((500, octaves), generator=torch.Generator().manual_seed(octaves)) \
        * torch.logspace(0, 5, octaves)
    lanes = 1 << (octaves.bit_length() - 1)
    v = u[:, :lanes].clone()
    v[:, :octaves - lanes] += u[:, lanes:]
    while v.shape[1] > 1:
        v = v[:, :v.shape[1] // 2] + v[:, v.shape[1] // 2:]
    assert torch.equal(fe._octave_sum(u), v[:, 0])


@pytest.mark.parametrize("octaves", [1, 5, 14, 16])
def test_the_octave_frequencies_are_float32_pi_times_powers_of_two(octaves):
    """The kernel's ``band(k)`` is float32(pi) * 2^k, exactly."""
    want = torch.tensor([np.float32(np.pi) * np.float32(2.0**k) for k in range(octaves)])
    assert torch.equal(fe.freq_bands(octaves), want)


def test_a_cpu_tensor_never_touches_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(hg, "_lib", refuse)
    before = dict(hg.LAUNCHES)
    x = _x((50, 3), 4).requires_grad_(True)
    nerf_encode(x, 12, torch.bfloat16).float().sum().backward()
    nerf_encode(x.detach(), 12)
    assert hg.LAUNCHES == before and x.grad is not None


@pytest.mark.parametrize("dims, octaves, dtype, error", [
    (0, 5, torch.float32, ValueError), (5, 5, torch.float32, ValueError),
    (3, 0, torch.float32, ValueError), (3, 17, torch.bfloat16, ValueError),
    (3, 5, torch.float16, TypeError), (3, 5, torch.float64, TypeError),
], ids=["dims0", "dims5", "octaves0", "octaves17", "f16", "f64"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_the_kernels_refuse_what_they_do_not_take(monkeypatch, which, dims, octaves, dtype, error):
    """The wrappers raise on dims outside 1..4, octaves outside 1..16 and an
    output other than float32 or bf16, before they touch the library."""
    monkeypatch.setattr(hg, "_lib", lambda: pytest.fail("the library was asked for"))
    x = torch.zeros((8, dims))
    with pytest.raises(error):
        if which == "fwd":
            fe.freq_encode_fwd_cuda(x, octaves, dtype)
        else:
            fe.freq_encode_bwd_cuda(x, torch.zeros((8, _width(dims, octaves)), dtype=dtype),
                                    octaves)


def test_the_kernels_refuse_a_cpu_tensor_in_range(monkeypatch):
    monkeypatch.setattr(hg, "_lib", lambda: pytest.fail("the library was asked for"))
    with pytest.raises(ValueError, match="CUDA"):
        fe.freq_encode_fwd_cuda(torch.zeros((8, 3)), 5, torch.bfloat16)


# ---------------------------------------------------------------------------
# the Functions on the CPU, their launches stood in for by the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def stand_ins(monkeypatch):
    """``nerf_encode`` through the autograd Functions on CPU tensors, each
    launch replaced by the plain version of the kernel and counted as the
    wrappers count."""

    def fwd(x, octaves, dtype, scenes=1):
        fe._check(x.shape[-1], octaves, dtype)
        hg._count("freq_encode_fwd", scenes)
        return fe.freq_encode_torch(x, octaves, dtype)

    def bwd(x, grad, octaves, scenes=1):
        fe._check(x.shape[-1], octaves, grad.dtype)
        hg._count("freq_encode_bwd", scenes)
        return fe.freq_encode_bwd_torch(x, grad, octaves)

    monkeypatch.setattr(fe, "freq_encode_fwd_cuda", fwd)
    monkeypatch.setattr(fe, "freq_encode_bwd_cuda", bwd)
    monkeypatch.setattr(encodings, "freq_encode", lambda x, octaves, dtype=None:
                        fe._FreqEncodeCUDA.apply(x.contiguous(), octaves,
                                                 dtype or torch.float32))
    hg.reset_launch_counts()
    yield
    hg.reset_launch_counts()


def _loss(x, octaves, dtype):
    out = nerf_encode(x, octaves, dtype).float()
    return (out * torch.linspace(-1.0, 1.0, out.shape[-1])).square().sum()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_functions_equal_the_plain_encoding(stand_ins, dtype):
    x = _x((3, 40, 3), 5).requires_grad_(True)
    out = nerf_encode(x, 7, dtype)
    assert torch.equal(out, fe.freq_encode_torch(x.detach(), 7, dtype))
    g = _g(out.shape, 6, dtype)
    out.backward(g)
    assert torch.equal(x.grad, fe.freq_encode_bwd_torch(x.detach(), g, 7))
    assert hg.LAUNCHES["freq_encode_fwd"] == hg.LAUNCHES["freq_encode_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_vmap_rules_equal_a_per_scene_loop(stand_ins, dtype):
    """``vmap(grad_and_value)`` over four scenes launches each kernel once
    for the four (SCENES counts them) and equals the loop of single-scene
    calls (the same rows, in other launches: equal to float32 rounding of
    the CPU's vectorised sin and cos)."""
    x = _x((SCENES, 2, 30, 3), 7)
    grads, values = vmap(grad_and_value(_loss), in_dims=(0, None, None))(x, 5, dtype)
    assert hg.LAUNCHES == {**dict.fromkeys(hg.LAUNCHES, 0), "freq_encode_fwd": 1,
                           "freq_encode_bwd": 1}
    assert hg.SCENES["freq_encode_fwd"] == hg.SCENES["freq_encode_bwd"] == SCENES
    for s in range(SCENES):
        g, v = grad_and_value(_loss)(x[s], 5, dtype)
        torch.testing.assert_close(values[s], v)
        torch.testing.assert_close(grads[s], g)
    out = vmap(lambda t: nerf_encode(t, 5, dtype), in_dims=1, out_dims=1)(x)
    torch.testing.assert_close(out, fe.freq_encode_torch(x, 5, dtype))


@pytest.fixture(scope="module")
def data():
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, fruit_radius=0.13, num_cameras=6,
                                              image_size=24, num_leaves=4), device="cpu")
    return dataset_from_scene(scene, "cpu")


def _network(name, n):
    """The benchmark's network: the preset with the sparsity prior."""
    preset, variant = {"big_tpu": ("fruit_nerf_big", "tpu"), "grid": ("fruit_nerf", "grid"),
                       "base_parity": ("fruit_nerf", "parity")}[name]
    return apply_overrides(get_preset(preset, n, variant=variant), {"sparsity_loss": 0.005})


def _small(cfg):
    """8 rays and 64 sparsity points a step, for the CPU."""
    model = dataclasses.replace(cfg.model, sparsity_num_points=64)
    return dataclasses.replace(cfg, model=model, train_rays_per_batch=8)


def expected_launches(name, steps, gated) -> dict:
    """The frequency-encoding launches of ``steps`` train steps, ``gated`` of
    which train the proposal fields: big tpu encodes the fine samples, the
    sparsity points and both proposal fields' samples, and takes the fine
    samples' backward every step (camera-opt gives the positions a
    gradient); grid encodes the proposal fields' samples; each proposal
    field's backward runs on the steps that train it; base parity encodes
    with hash grids only."""
    fwd, bwd = {"big_tpu": (4, 1), "grid": (2, 0), "base_parity": (0, 0)}[name]
    proposals = 2 if name != "base_parity" else 0
    return {"freq_encode_fwd": fwd * steps, "freq_encode_bwd": bwd * steps + proposals * gated}


@pytest.mark.parametrize("name", ["big_tpu", "grid", "base_parity"])
def test_a_train_step_launches_as_the_card_step_does(stand_ins, data, name):
    cfg = _small(_network(name, data.cameras.num_cameras))
    state = init_train_state(cfg, data.cameras.num_cameras, "cpu",
                             generator=torch.Generator().manual_seed(0))
    start = state.step = 10_000
    gen = torch.Generator().manual_seed(1)
    steps = 5
    for _ in range(steps):
        train_step(state, data, cfg, draws=draw_step(cfg, data, gen))
    gated = sum(proposal_updated(s, cfg.model) for s in range(start, start + steps))
    assert gated == 1
    want = expected_launches(name, steps, gated)
    assert {k: hg.LAUNCHES[k] for k in want} == want
    assert hg.SCENES == hg.LAUNCHES


def test_the_multi_scene_step_launches_once_for_all_scenes(stand_ins, data):
    cfg = _small(_network("grid", data.cameras.num_cameras))
    datas = ms.stack_datasets([data] * 2)
    state, gens = ms.init_multi_scene_state(cfg, data.cameras.num_cameras, 2, "cpu")
    state.step = 10_000  # gated
    assert proposal_updated(state.step, cfg.model)
    ms.multi_scene_step(state, datas, cfg, gens)
    want = expected_launches("grid", 1, 1)
    assert {k: hg.LAUNCHES[k] for k in want} == want
    assert all(hg.SCENES[k] == 2 * n for k, n in want.items())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

# (rows, octaves) of the main path: big tpu's fine samples (1,048,576 x 14),
# its proposal fields (8192 rays x 512 and x 256 samples: 4 M x 5, 2 M x 7),
# and an eval-sized chunk
CARD_SHAPES = [(1_048_576, 14), (4_194_304, 5), (2_097_152, 7), (4096, 14)]
CARD_IDS = ["1M-x14", "4M-x5", "2M-x7", "4096-x14"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    hg.build_kernels()
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows, octaves", CARD_SHAPES, ids=CARD_IDS)
def test_the_forward_is_the_plain_composition_bitwise(card, rows, octaves, dtype):
    x = _x((rows, 3), octaves, card)
    before = hg.LAUNCHES["freq_encode_fwd"]
    out = fe.freq_encode_fwd_cuda(x, octaves, dtype)
    assert hg.LAUNCHES["freq_encode_fwd"] == before + 1
    ref = fe.freq_encode_torch(x, octaves, dtype)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert torch.equal(nerf_encode(x, octaves, dtype), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows, octaves", CARD_SHAPES, ids=CARD_IDS)
def test_the_backward_is_autograd_of_the_plain_composition_bitwise(card, rows, octaves, dtype):
    """The kernel is the closed form bitwise, and both are autograd of the
    plain composition bitwise: the same roundings, the octaves summed in
    the order of ATen's CUDA sum."""
    x = _x((rows, 3), 20 + octaves, card)
    g = _g((rows, _width(3, octaves)), 3, dtype, card)
    dx = fe.freq_encode_bwd_cuda(x, g, octaves)
    assert torch.equal(dx, fe.freq_encode_bwd_torch(x, g, octaves))
    a = x.clone().requires_grad_(True)
    fe.freq_encode_torch(a, octaves, dtype).backward(g)
    assert torch.equal(dx, a.grad)
    b = x.clone().requires_grad_(True)
    nerf_encode(b, octaves, dtype).backward(g)
    assert torch.equal(b.grad, dx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_vmap_rules_equal_single_launches_bitwise(card, dtype):
    """Four scenes of the campaign's proposal 0 (2048 rays x 256 samples, 5
    octaves) through the ``vmap`` rules, and under ``vmap(grad_and_value)``:
    each scene bitwise its single launch, one launch for the four."""
    x = _x((SCENES, 2048, 257, 3), 8, card)
    hg.reset_launch_counts()
    out = vmap(lambda t: nerf_encode(t, 5, dtype))(x)
    assert hg.LAUNCHES["freq_encode_fwd"] == 1 and hg.SCENES["freq_encode_fwd"] == SCENES
    for s in range(SCENES):
        assert torch.equal(out[s], fe.freq_encode_fwd_cuda(x[s], 5, dtype))

    def loss(t):
        out = nerf_encode(t, 5, dtype).float()
        return (out * torch.linspace(-1.0, 1.0, out.shape[-1], device=card)).square().sum()

    hg.reset_launch_counts()
    grads, values = vmap(grad_and_value(loss))(x)
    assert hg.LAUNCHES["freq_encode_bwd"] == 1 and hg.SCENES["freq_encode_bwd"] == SCENES
    for s in range(SCENES):
        g, v = grad_and_value(loss)(x[s])
        assert torch.equal(grads[s], g)
        # the loss's own sum is ATen's reduction, which vmap batches in
        # another order: equal to float32 rounding
        torch.testing.assert_close(values[s], v, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def card_data(card):
    scene = render_scene(SyntheticSceneConfig(image_size=64, num_cameras=8), device=card)
    return dataset_from_scene(scene, card)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["big_tpu", "grid", "base_parity"])
def test_the_launch_counter_on_a_card_step(card_data, name):
    """Five eager steps from 10,000 (one trains the proposal fields) at the
    preset's rays: the counter rises on big tpu and grid and stays 0 on the
    base parity network."""
    data = card_data
    cfg = _network(name, data.cameras.num_cameras)
    state = init_train_state(cfg, data.cameras.num_cameras, data.images.device,
                             generator=torch.Generator(device=data.images.device).manual_seed(0))
    start = state.step = 10_000
    gen = torch.Generator(device=data.images.device).manual_seed(1)
    hg.reset_launch_counts()
    steps = 5
    for _ in range(steps):
        train_step(state, data, cfg, draws=draw_step(cfg, data, gen))
    torch.cuda.synchronize()
    gated = sum(proposal_updated(s, cfg.model) for s in range(start, start + steps))
    want = expected_launches(name, steps, gated)
    assert {k: hg.LAUNCHES[k] for k in want} == want
    assert (want["freq_encode_fwd"] > 0) == (name != "base_parity")
