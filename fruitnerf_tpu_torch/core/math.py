"""Core numeric primitives. Twin of ``fruitnerf_tpu/core/math.py``.

The JAX package's ``batched_searchsorted`` and ``take_sorted`` are TPU
formulations (a comparison count and a masked prefix maximum); here they are
``torch.searchsorted`` and a rowwise index on rows that are sorted
ascending, which gives the same values.
"""
from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    # the setup_context form, so that it runs under torch.func (the
    # multi-scene step is a vmap of grad); its body is elementwise
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.exp(torch.clamp(x, -30.0, 30.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with a bounded exponent: the forward clips at +-30, the backward
    at +-15."""
    return _TruncExp.apply(x)


def scene_contraction_inf(x: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF-360 contraction with the L-infinity norm: R^3 -> (-2, 2)^3,
    identity inside the unit cube."""
    mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    mag = torch.clamp_min(mag, 1e-12)
    contracted = (2.0 - 1.0 / mag) * (x / mag)
    return torch.where(mag <= 1.0, x, contracted)


def contract_to_unit(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World positions -> ([0,1]^3 grid positions, selector). Positions that
    land outside the open unit cube are zeroed and get a False selector."""
    pos = (scene_contraction_inf(x) + 2.0) / 4.0
    selector = torch.all((pos > 0.0) & (pos < 1.0), dim=-1)
    pos = pos * selector[..., None]
    return pos, selector


def normalize_aabb_to_unit(
    x: torch.Tensor, aabb: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """World positions -> ([0,1]^3 grid positions, selector) by an AABB
    ([2, 3]: min and max rows), the export path's input map. As in
    ``contract_to_unit``, positions outside the open unit cube (a probe on
    the box's face included) are zeroed and get a False selector."""
    pos = (x - aabb[0]) / (aabb[1] - aabb[0])
    selector = torch.all((pos > 0.0) & (pos < 1.0), dim=-1)
    pos = pos * selector[..., None]
    return pos, selector


def batched_searchsorted(
    a: torch.Tensor, v: torch.Tensor, side: str = "right"
) -> torch.Tensor:
    """Rowwise searchsorted: a [R, K] sorted ascending, v [R, Q] -> [R, Q]."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=side == "right")


def take_sorted(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rowwise gather vals[r, idx[r, q]]. (The JAX twin's masked maximum
    splits a gradient among tied values; this gives it to the one read.)

    An advanced index, not ``torch.gather``: on CUDA the index's backward
    is ``index_put_(accumulate=True)``, which sorts the indices and sums
    each run in order, so it repeats bitwise; gather's backward adds float
    atomics in whatever order they land (PyTorch lists it among the
    nondeterministic ops, ``torch.use_deterministic_algorithms``)."""
    v, i = vals.reshape(-1, vals.shape[-1]), idx.reshape(-1, idx.shape[-1])
    rows = torch.arange(v.shape[0], device=v.device)[:, None]
    return v[rows, i].reshape(idx.shape)
