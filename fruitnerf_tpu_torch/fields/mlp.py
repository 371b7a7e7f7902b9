"""Minimal functional MLPs on parameter dicts. Twin of
``fruitnerf_tpu/fields/mlp.py``: activations flow in a compute dtype
(bfloat16 on the card), parameters and outputs stay float32.

A layer named in ``MLPConfig.skips`` takes ``cat([input, hidden])``, the
MLP's input joined again before its hidden features (nerfstudio's
``skip_connections``). It is one product of the joined input: split into
``x @ w[:in] + h @ w[in:]``, the two bf16 products round apart from the
joined one, and a frequency encoding's input gradient and the pdf
sampler's backward magnify that to a tenth of a proposal field's gradient.

Each layer's matrix product ``h @ w`` goes through ``_SceneLinear``, an
autograd Function that issues, outside ``torch.func.vmap``, exactly the
products autograd issues for ``h @ w``: ``mm(h, w)``, ``mm(g, w.t())`` and
``mm(h.t(), g)``. Under ``vmap`` over scenes (the multi-scene step,
``parallel/multi_scene.py``) its ``vmap`` rules issue those same products
once a scene, each scene's operands contiguous, in place of the batched
GEMMs that ``vmap`` makes of them: a batched weight gradient (tiny output,
a reduction over every sample of a scene) gets a few output tiles and an
sm_75 kernel that does not split the reduction, where the single-scene
product is split over it by cuBLAS (PERF.md §5). Scene s's products equal
those of a step of scene s alone, bitwise on the same operands.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.hash_grid import _scene_first

# Scene-batched products issued by the vmap rules (a forward, an input
# gradient and a weight gradient each count one, whatever the scenes), in
# eager steps and at a CUDA graph's capture: a replay runs no Python.
scene_linear_calls = 0


def _at(t: torch.Tensor, dim, s: int) -> torch.Tensor:
    """Scene s of a scene-first operand; an unbatched one (dim None) is
    every scene's."""
    return t if dim is None else t[s]


def _scene_mms(scenes: int, a: torch.Tensor, a_dim, b: torch.Tensor, b_dim) -> torch.Tensor:
    """[scenes, m, n]: row s is ``mm`` of scene s's ``a`` and ``b``, one
    product a scene, written in place."""
    pairs = [(_at(a, a_dim, s), _at(b, b_dim, s)) for s in range(scenes)]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        # plain autograd around the vmap records the products, and it records
        # none written with out=: stack them (a copy)
        out = torch.stack([x.mm(y) for x, y in pairs])
    else:
        out = a.new_empty((scenes, a.shape[-2], b.shape[-1]))
        for s, (x, y) in enumerate(pairs):
            torch.mm(x, y, out=out[s])
    global scene_linear_calls
    scene_linear_calls += 1
    return out


# Both Functions take the setup_context form, so that they run under
# torch.func (the multi-scene step is a vmap of grad). The backward issues
# its products through a second Function, whose own vmap rule issues them a
# scene at a time under a vmap; it is not differentiable again.


class _SceneLinearBwd(torch.autograd.Function):
    @staticmethod
    def forward(h, w, g, needs_h, needs_w):
        return (g.mm(w.t()) if needs_h else None), (h.t().mm(g) if needs_w else None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, h, w, g, needs_h, needs_w):
        h_dim, w_dim, g_dim = in_dims[:3]
        h, w, g = _scene_first(in_dims[:3], h, w, g)
        n = info.batch_size
        dh = _scene_mms(n, g, g_dim, w.transpose(-2, -1), w_dim) if needs_h else None
        dw = _scene_mms(n, h.transpose(-2, -1), h_dim, g, g_dim) if needs_w else None
        return (dh, dw), (None if dh is None else 0, None if dw is None else 0)


class _SceneLinear(torch.autograd.Function):
    @staticmethod
    def forward(h, w):
        return h.mm(w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        return _SceneLinearBwd.apply(h, w, g, *ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, h, w):
        h, w = _scene_first(in_dims, h, w)
        return _scene_mms(info.batch_size, h, in_dims[0], w, in_dims[1]), 0


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    num_layers: int  # total linear layers (num_layers >= 1)
    hidden_dim: int
    out_dim: int
    out_sigmoid: bool = False  # hidden layers are ReLU; the output is linear or sigmoid
    # layers whose input is [the MLP's input, the hidden features]; off by default
    skips: tuple = ()

    def layer_dims(self) -> list[tuple[int, int]]:
        """[(d_in, d_out)] of each layer, a skip layer's d_in the joined one."""
        dims = [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [self.out_dim]
        return [(a + (self.in_dim if i in self.skips else 0), b)
                for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def init_mlp(
    config: MLPConfig, generator: torch.Generator, device
) -> dict[str, torch.Tensor]:
    """He-uniform weights [d_in, d_out], zero biases."""
    params = {}
    for i, (d_in, d_out) in enumerate(config.layer_dims()):
        bound = (6.0 / d_in) ** 0.5
        u = torch.rand((d_in, d_out), generator=generator, device=device)
        params[f"w{i}"] = u * (2.0 * bound) - bound
        params[f"b{i}"] = torch.zeros((d_out,), device=device)
    return params


def apply_mlp(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    config: MLPConfig,
    compute_dtype: torch.dtype = torch.float32,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Forward pass in ``compute_dtype``; returns ``out_dtype``."""
    batch_shape = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    x_in = h
    n = config.num_layers
    for i in range(n):
        if i in config.skips:
            h = torch.cat([x_in, h], dim=-1)
        w = params[f"w{i}"].to(compute_dtype)
        h = _SceneLinear.apply(h, w) + params[f"b{i}"].to(compute_dtype)
        if i < n - 1:
            h = torch.relu(h)
    h = h.to(out_dtype).reshape(*batch_shape, config.out_dim)
    return torch.sigmoid(h) if config.out_sigmoid else h
