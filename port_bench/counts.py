"""The yardstick: the least time of a train step's required work on one
H100, counted from a configuration's shapes.

Each piece takes max(operations / the peak at its precision, bytes / the
memory rate); a step's least time is the sum over its pieces:

* every MLP layer's forward, and on the steps that train it its backward
  (the weight gradient, and the input gradient after the first layer and
  at a first layer whose input trains a table or feeds another MLP);
* every grid encoding call, by the arithmetic of
  ``chip_smoke.py:work`` (frozen here): each input read once and each
  output written once, of the table only the distinct rows the call's
  positions touch, and in the backward the whole dTable written once;
* the optimizer's update of every parameter, its reads and writes once.

The sampler, the renderer, the losses and the elementwise work between
the pieces are not counted, so the least time is a lower bound and a share
of it cannot pass 100%. Nothing here reads the profiler or the port.
"""
from __future__ import annotations

import torch

from . import layout as LY
from .reference.model import (
    field_encoding,
    mlp_dims,
    proposal_mlp_dims,
    proposal_updated,
)
from .weights import leaf_specs

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# float32 operations per (point, level), from the kernels' arithmetic
# (chip_smoke.py): s = pos * res, floor, t (9), 1 - t (3), 8 corner weights (16)
CELL_FWD_OPS = 28 + 32  # 16 FMAs into the two features
CELL_BWD_OPS = 28 + 16  # 16 dTable products
CELL_DPOS_OPS = 24 + 96 + 6
ADAM_BYTES = 7 * 4  # read p, g, m, v; write p, m, v (float32)
ADAM_OPS = 12


def corner_fwd_ops(f: int) -> int:
    return 28 + 16 * f


def corner_bwd_ops(f: int) -> int:
    return 28 + 8 * f


def corner_dpos_ops(f: int) -> int:
    return 8 * (2 * f - 1) + 96 + 6


def least(nbytes: float, ops: float, peak: float) -> float:
    """Seconds: the larger of bytes over the memory rate and operations
    over ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def touched_rows(lay: LY.Layout, pos: torch.Tensor) -> int:
    """Distinct valid table rows that positions [P, 3] in [0,1]^3 read."""
    total = 0
    for lvl in range(lay.num_levels):
        rows, valid, _ = LY.lookups(pos, lay, lvl)
        total += int(torch.unique(rows[valid]).numel())
    return total


def grid_call(lay: LY.Layout, p: int, touched: int, backward: bool, dpos: bool) -> float:
    """Least seconds of one grid-encoding forward (or backward) launch on
    ``p`` positions."""
    nl, f = lay.num_levels, lay.features
    row_bytes = 4 * lay.width
    out_bytes = 4 * f * nl * p
    if lay.corner:
        f_ops, b_ops, d_ops = corner_fwd_ops(f), corner_bwd_ops(f), corner_dpos_ops(f)
    else:
        f_ops, b_ops, d_ops = CELL_FWD_OPS, CELL_BWD_OPS, CELL_DPOS_OPS
    if not backward:
        return least(12 * p + out_bytes + row_bytes * touched, f_ops * p * nl, PEAK_FP32_FLOPS)
    nbytes = 12 * p + out_bytes + row_bytes * lay.total_rows + row_bytes * touched \
        + (12 * p if dpos else 0)
    return least(nbytes, (b_ops + (d_ops if dpos else 0)) * p * nl, PEAK_FP32_FLOPS)


def mlp_pass(n: int, dims: tuple, dtype: str, backward: bool, first_dx: bool) -> float:
    """Least seconds of an MLP's forward over ``n`` rows, or of its backward
    (weight gradients; input gradients after the first layer, and at the
    first with ``first_dx``)."""
    d_in, nl, hid, d_out, _ = dims
    ds = [d_in] + [hid] * (nl - 1) + [d_out]
    es = 2 if dtype == "bfloat16" else 4
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    s = 0.0
    for i in range(nl):
        a, b = ds[i], ds[i + 1]
        flops = 2.0 * n * a * b
        if not backward:
            s += least(es * (n * a + n * b + a * b), flops, peak)
            continue
        s += least(es * (n * a + n * b) + es * a * b + 4 * a * b, flops, peak)  # dW
        if i > 0 or first_dx:
            s += least(es * (n * a + n * b + a * b), flops, peak)  # dX
    return s


def num_params(cfg: dict, num_images: int) -> int:
    return sum(int(torch.Size(shape).numel()) for _, shape, _, _ in leaf_specs(cfg, num_images))


def step_least(cfg: dict, num_images: int, touched: dict, step: int) -> dict:
    """{piece: least seconds} of one scene's train step at ``step`` (which
    decides whether the proposal fields train), and "total". ``touched``:
    {grid call name: distinct rows} ("field", "sparsity", "proposal<i>")."""
    m = cfg["model"]
    field = m["field"]
    r = cfg["train_rays_per_batch"]
    updated = proposal_updated(step, m)
    dpos = bool(cfg["use_camera_opt"])  # ray samples move with the camera poses
    out = {"grid_fwd": 0.0, "grid_bwd": 0.0, "mlp": 0.0, "optimizer": 0.0}
    fine = r * m["num_nerf_samples"]
    dims = mlp_dims(field)
    fdt = field["compute_dtype"]
    table = field["encoding"] != "freq"
    if table:
        lay = LY.encoding_layout(field_encoding(field))
        out["grid_fwd"] += grid_call(lay, fine, touched["field"], False, dpos)
        out["grid_bwd"] += grid_call(lay, fine, touched["field"], True, dpos)
    first_dx = {"base_mlp": table, "color_mlp": True, "semantic_mlp": False,
                "semantic_head": True}
    for name, d in dims.items():
        out["mlp"] += mlp_pass(fine, d, fdt, False, False)
        out["mlp"] += mlp_pass(fine, d, fdt, True, first_dx[name])
    if m["density_sparsity_mult"] > 0:
        sp = m["sparsity_num_points"]
        if table:
            out["grid_fwd"] += grid_call(lay, sp, touched["sparsity"], False, False)
            out["grid_bwd"] += grid_call(lay, sp, touched["sparsity"], True, False)
        out["mlp"] += mlp_pass(sp, dims["base_mlp"], fdt, False, False)
        out["mlp"] += mlp_pass(sp, dims["base_mlp"], fdt, True, table)
    for i, net in enumerate(m["proposal_nets"]):
        n = r * m["num_proposal_samples"][i]
        pd = proposal_mlp_dims(net)
        hashed = net["kind"] == "hash"
        if hashed:
            lay_p = LY.encoding_layout(net["hash"])
            out["grid_fwd"] += grid_call(lay_p, n, touched[f"proposal{i}"], False, dpos)
        out["mlp"] += mlp_pass(n, pd, net["compute_dtype"], False, False)
        if updated:
            if hashed:
                out["grid_bwd"] += grid_call(lay_p, n, touched[f"proposal{i}"], True, dpos)
            out["mlp"] += mlp_pass(n, pd, net["compute_dtype"], True, hashed)
    n_p = num_params(cfg, num_images)
    out["optimizer"] = least(ADAM_BYTES * n_p, ADAM_OPS * n_p, PEAK_FP32_FLOPS)
    out["total"] = sum(out.values())
    return out


def window_least(cfg: dict, num_images: int, touched_per_scene: list, steps) -> dict:
    """{piece: least seconds} summed over the window's ``steps`` (their
    step numbers) and over the scenes (one ``touched`` dict a scene)."""
    acc: dict = {}
    for step in steps:
        for touched in touched_per_scene:
            for k, v in step_least(cfg, num_images, touched, step).items():
                acc[k] = acc.get(k, 0.0) + v
    return acc
