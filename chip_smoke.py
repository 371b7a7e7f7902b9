#!/usr/bin/env python3
"""Drive the PyTorch port once on an NVIDIA GPU: build the CUDA kernels from
this checkout, hold each against its plain PyTorch version, train the
full-width ``fruit_nerf`` grid preset (cell mode, by hand) and its corner-mode
grid (through ``train_loop``, with evals and checkpoints) for a few hundred
steps each on a synthetic scene, and resume and render; then run the
fruit-counting main path, ``orchard-e2e``, on the bench orchard.

    python3 chip_smoke.py [--steps 400] [--seed 0]
    python3 chip_smoke.py --ab-cell-source OTHER/cell_encode.cu [--steps 200]
    python3 chip_smoke.py --ab-corner-source OTHER/corner_encode.cu [--steps 200]

Phases, each printing its lines:
  card     nvidia-smi's name and power limit; TF32 switched off for matmuls
           and cuDNN
  build    nvcc of fruitnerf_tpu_torch/csrc into fruitnerf_tpu_torch/_build;
           registers, shared memory and spills of each kernel (the cell
           kernels and the corner kernels at F = 2 and 4 must not spill)
  kernels  at P = 4096*48 + 4096 uniform-random points, each kernel pair
           against its plain version: max errors and median times, each
           launch's bound (bytes at 3.35 TB/s or float32 operations at 67
           TFLOP/s, whichever is larger; of the table, the rows the points
           touch) and the time of the F.embedding_bag yardstick on
           precomputed corner indices (held to the plain version too). K1/K2
           (cell_encode.cu) at the cell slice's layout; K3/K4
           (corner_encode.cu) at the corner slice's (16 levels, T = 8192,
           F = 2) and at a small F = 4 layout; K5/K6 (cell v1, the cell
           kernels at a uniform 16-level T = 8192 layout) through
           grid_encode_flat(mode="cell") and its autograd, after one counted
           forward and backward through that entry (cell v1's only path: no
           training path reaches it); then K1 alone at an export batch (2^22
           probes, placed as the orchard export places them, the box's faces
           zeroed by the AABB selector)
  parity   one small train step's losses and colour-MLP gradient on the GPU
           (kernels) against the CPU (plain version), same parameters and draws
  slice    the cell-mode training steps: finite losses, PSNR rising, every
           step through K1 and K2; steps/s and rays/s; a held-out render. The
           last step's two grid encodings are captured: K1/K2 are then held
           and timed at those positions (196,608 ray-ordered fine samples and
           4,096 sparsity points, each its own launch, as the step has them)
  corner   train_loop on the corner-mode grid, logging every step and
           evaluating and checkpointing every 100: finite losses, PSNR
           rising, every step through K3 and K4, finite eval stats with SSIM
           in [-1, 1]; steps/s and rays/s (the per-step log syncs the host
           each step; the cell slice does not). Then the manifest, whose grid entry
           must rebuild the layout, and a resume into a fresh state that must
           equal the trained one and render the held-out camera identically.
           The last step's two grid encodings are captured (from
           grid_encode_flat) and K3/K4 held and timed at them, as K1/K2 are
  orchard  scripts.orchard_e2e.main on the bench orchard (120 fruits, 200
           cameras at 256^2, rendered once, into the scene cache it reads,
           by the torch renderer above the numpy tracer's 2M ray-sphere
           pairs; camera 0's mask held to the numpy tracer's),
           ORCHARD_ITERS full-width steps, sparsity 0.005, an export at
           N = EXPORT_N and the counting cascade (the native counting
           library must load). Checks that the reports name the card, K1/K2
           launches in training (>= 2 and >= 1 a step) and K1's in export
           (one a batch), a non-empty density cloud, finite eval stats; then
           a second call on the same directory, which must resume at the
           final step, run zero steps, report null rates and export the
           same clouds
Then one JSON line of the six kernels (K1/K2's launches summed over the cell
slice and the orchard phase's counted calls; the K1-K4 entries also carry
their step-layout numbers, K1's its export-batch ones), the card line,
and as the last line {"ok": true, "device": {...}}. It fails if jax or any
module of the JAX package (fruitnerf_tpu) was imported. Any failure raises
and exits non-zero; with no CUDA device it exits non-zero before printing
any result.

With --ab-cell-source it builds that other cell_encode.cu (the same C
interface; for example the parent commit's, from git show) apart, runs only
the card, build and cell slice phases, and times the other K1/K2 ("old")
against this checkout's ("new") and the plain version in turns (plain, old,
new, new, old, plain) at random points, at the last step's positions and at
an export batch, each held to the plain version first. --ab-corner-source
does the same for another corner_encode.cu's K3/K4 after the corner slice,
at random points and the corner step's positions, at the slice's F = 2
layout and at the kernel phase's F = 4 layout. Either or both; then one
JSON line of those times, bounds and yardstick times, and the card line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FWD_ATOL = 1e-5  # forward kernels: float32 sums of 8 products of O(1) values
BWD_RTOL = 1e-4  # backward kernels: relative to each gradient's max; atomics reorder sums
LOSS_RTOL = 1e-4  # small-input step, GPU against CPU, float32
GRAD_RTOL = 1e-3  # its gradients, relative to each one's max magnitude
P_SLICE = 4096 * 48 + 4096  # fine samples plus sparsity points of one step
ORCHARD_ITERS = 2000  # the orchard phase's steps: a few minutes on the card
EXPORT_N = 256  # its export's probe grid side: 2^24 probes in 4 batches


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` between CUDA events. Before each run the
    card is held busy (``torch.cuda._sleep``) for twice the host's time to
    queue ``fn``, so the events bracket the device's work alone and not the
    Python and launch overhead in front of a short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_cycles = int(2e9 * max(2.0 * host_s, 1e-4))  # 2 GHz over-counts the SM clock
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


TPU = "fruitnerf_tpu/ops/pallas/hash_grid.py"
CELL_SRC = "fruitnerf_tpu_torch/csrc/cell_encode.cu"
CORNER_SRC = "fruitnerf_tpu_torch/csrc/corner_encode.cu"
CORNER_F4 = ((8, 64, 1024, 2048), 4096)  # the kernel phase's small F = 4 corner layout


def _kernel_name(mangled: str) -> str:
    """``_Z24corner_encode_bwd_kernelILi2EEv...`` -> ``corner_encode_bwd_kernel<2>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if m is None:
        return mangled
    rest = mangled[m.end():]
    name, rest = rest[: int(m.group(1))], rest[int(m.group(1)):]
    f = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{f.group(1)}>" if f else name


def kernel_resources(log: str) -> list[dict]:
    """Each kernel's registers, static shared memory (the corner kernels
    size theirs at launch) and spills, from nvcc's ``-Xptxas -v`` output."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append({"name": _kernel_name(m.group(1)), "registers": None, "smem": 0,
                        "spill_stores": 0, "spill_loads": 0})
        elif out:
            k = out[-1]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                k["spill_stores"], k["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                k["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            if m:
                k["smem"] = int(m.group(1))
    return out


def build_phase(hg) -> list[dict]:
    """Build the kernels and print each one's resources; the cell kernels
    and the corner kernels at F = 2 and F = 4 must not spill."""
    info = hg.build_kernels()
    kernels = kernel_resources(info.log)
    print(f"build: {info.seconds:.2f} s -> {info.path.parent.name}; {len(kernels)} kernels")
    for k in kernels:
        print(f"build: {k['name']}: {k['registers']} registers, {k['smem']} bytes static smem, "
              f"spill stores {k['spill_stores']} B, loads {k['spill_loads']} B")
    check(len(kernels) > 0, "nvcc's log names no kernel")
    for k in kernels:
        if "<" not in k["name"] or k["name"].endswith(("<2>", "<4>")):
            check(k["spill_stores"] == k["spill_loads"] == 0, f"{k['name']} spills registers")
    return kernels


# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# float32 operations over the rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per (point, level), counted from the kernels' code:
# s = pos * res, floor, t (9), 1 - t (3), 8 corner weights (16); then
CELL_FWD_OPS = 28 + 32  # 16 FMAs into the two features
CELL_BWD_OPS = 28 + 16  # 16 dTable products; dPos adds CELL_DPOS_OPS
CELL_DPOS_OPS = 24 + 96 + 6  # 8 corner dots (3 each), 8 x 3 axis terms (4 each), scale


def corner_fwd_ops(f: int) -> int:
    return 28 + 16 * f  # 8 corners x F FMAs


def corner_bwd_ops(f: int) -> int:
    return 28 + 8 * f  # 8 corners x F dTable products; dPos adds corner_dpos_ops


def corner_dpos_ops(f: int) -> int:
    return 8 * (2 * f - 1) + 96 + 6


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lookups(hg, pos, layout, corner: bool):
    """The rows a launch reads: (flat row index, valid) per (point, level) in
    cell mode, per (point, level, corner) in corner mode, and the trilinear
    weights [P, L, 8], as the plain versions compute them."""
    dev = pos.device
    res = torch.tensor(layout.resolutions, dtype=torch.float32, device=dev)
    s = pos[:, None, :] * res[None, :, None]  # [P, L, 3]
    f0 = torch.floor(s)
    frac = s - f0
    bits = torch.tensor((hg._CX, hg._CY, hg._CZ), dtype=torch.int64, device=dev)  # [3, 8]
    on = bits.bool()
    tx, ty, tz = (frac[..., a : a + 1] for a in range(3))
    w8 = (torch.where(on[0], tx, 1.0 - tx) * torch.where(on[1], ty, 1.0 - ty)
          * torch.where(on[2], tz, 1.0 - tz))  # [P, L, 8]
    if corner:
        ix, iy, iz = (f0.long()[..., :, None] + bits).unbind(-2)  # [P, L, 8]
        stride = torch.tensor(layout.resolutions, dtype=torch.int64, device=dev)[:, None] + 1
    else:
        ix, iy, iz = f0.long().unbind(-1)  # [P, L]
        stride = torch.tensor(layout.resolutions, dtype=torch.int64, device=dev)
    flat, valid = hg._hash_or_direct(ix, iy, iz, stride, layout)
    return flat, valid, w8


def work(hg, pos, layout, features: int, corner: bool) -> dict:
    """Bytes and operations of a forward and a backward launch (with dPos)
    on these positions: each input read once, each output written once, and
    of the table only the rows these positions touch (the whole dTable is
    written)."""
    p, nl = pos.shape[0], layout.num_levels
    flat, valid, _ = lookups(hg, pos, layout, corner)
    touched = int(torch.unique(flat[valid]).numel())
    row_bytes = 4 * (features if corner else 16)
    out_bytes = 4 * features * nl * p
    dtable_bytes = row_bytes * layout.total_rows
    if corner:
        f_ops, b_ops, d_ops = corner_fwd_ops(features), corner_bwd_ops(features), \
            corner_dpos_ops(features)
    else:
        f_ops, b_ops, d_ops = CELL_FWD_OPS, CELL_BWD_OPS, CELL_DPOS_OPS
    fwd = bound(12 * p + out_bytes + row_bytes * touched, f_ops * p * nl)
    bwd = bound(12 * p + out_bytes + dtable_bytes + 12 * p + row_bytes * touched,
                (b_ops + d_ops) * p * nl)
    return {"touched_rows": touched, "fwd": fwd, "bwd": bwd}


def bag_inputs(hg, pos, layout, corner: bool):
    """The yardstick's inputs: the [P*L, 8] corner indices into the table
    viewed as [sum T_l * 8, 2] (cell mode, index row*8 + c) or as [L*T, F]
    (corner mode), and their trilinear weights, zero where the row is
    outside its level's table."""
    p, nl = pos.shape[0], layout.num_levels
    flat, valid, w8 = lookups(hg, pos, layout, corner)
    idx = flat if corner else flat[..., None] * 8 + torch.arange(8, device=pos.device)
    w = w8 * valid.reshape(p, nl, -1)
    return idx.reshape(p * nl, 8).contiguous(), w.reshape(p * nl, 8).contiguous()


def library_pair(hg, table, pos, grad, layout, corner: bool):
    """The yardstick: one ``F.embedding_bag(mode="sum",
    per_sample_weights=w)`` call on ``bag_inputs``, made here, outside the
    timed calls. It leaves out the index math and dPositions. ->
    (forward(), its autograd dTable backward(), None without ``grad``)."""
    import torch.nn.functional as F

    p = pos.shape[0]
    idx, w = bag_inputs(hg, pos, layout, corner)
    weight = table if corner else table.view(-1, 2)

    def forward():
        return F.embedding_bag(idx, weight, mode="sum", per_sample_weights=w).view(p, -1)

    if grad is None:
        return forward, None
    leaf = weight.detach().clone().requires_grad_(True)
    out_graph = F.embedding_bag(idx, leaf, mode="sum", per_sample_weights=w)
    g = grad.reshape(out_graph.shape)

    def backward():
        return torch.autograd.grad(out_graph, leaf, g, retain_graph=True)[0].view(table.shape)

    return forward, backward


def hold_pair(label, fwd, bwd, plain, table, pos, grad, library=None, cost=None) -> dict:
    """A forward kernel ``fwd(table, pos)`` and its backward ``bwd(table,
    pos, grad) -> (dTable, dPos)`` against the plain version's forward and
    autograd backward, on the same inputs: errors (checked) and median
    times of each. With ``bwd=None`` the backward is taken through
    autograd of ``fwd``, as a training step takes it. ``library`` is the
    yardstick's (forward(), backward()) pair, held to the same limits and
    timed; ``cost`` is ``work``'s bounds of the two launches."""
    if bwd is None:
        t_k = table.clone().requires_grad_(True)
        p_k = pos.clone().requires_grad_(True)
        out_graph = fwd(t_k, p_k)

        def bwd(t, p, gr):
            return torch.autograd.grad(out_graph, (t_k, p_k), gr, retain_graph=True)
    out_k = fwd(table, pos)
    out_p = plain(table, pos)
    dt_k, dp_k = bwd(table, pos, grad)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    plain_out = plain(t_, p_)
    dt_p, dp_p = torch.autograd.grad(plain_out, (t_, p_), grad, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err = (out_k - out_p).abs().max().item()
    dt_err = (dt_k - dt_p).abs().max().item()
    dp_err = (dp_k - dp_p).abs().max().item()
    dt_rel = dt_err / dt_p.abs().max().item()
    dp_rel = dp_err / dp_p.abs().max().item()
    print(f"kernels: {label} forward max abs err {fwd_err:.3e} (tol {FWD_ATOL:g}); "
          f"backward dTable max err / max |dTable| {dt_rel:.3e}, dPos {dp_rel:.3e} "
          f"(tol {BWD_RTOL:g})")
    check(fwd_err <= FWD_ATOL, f"{label} forward error {fwd_err} > {FWD_ATOL}")
    check(dt_rel <= BWD_RTOL, f"{label} dTable relative error {dt_rel} > {BWD_RTOL}")
    check(dp_rel <= BWD_RTOL, f"{label} dPos relative error {dp_rel} > {BWD_RTOL}")
    times = {
        "fwd_ms": median_ms(lambda: fwd(table, pos)),
        "fwd_plain_ms": median_ms(lambda: plain(table, pos)),
        "bwd_ms": median_ms(lambda: bwd(table, pos, grad)),
        "bwd_plain_ms": median_ms(
            lambda: torch.autograd.grad(plain_out, (t_, p_), grad, retain_graph=True)),
        "fwd_library_ms": None, "bwd_library_ms": None,
    }
    if library is not None:
        lib_fwd, lib_bwd = library
        lf_err = (lib_fwd() - out_p).abs().max().item()
        lb_rel = (lib_bwd() - dt_p).abs().max().item() / dt_p.abs().max().item()
        print(f"kernels: {label} embedding_bag yardstick forward max abs err {lf_err:.3e}, "
              f"dTable {lb_rel:.3e} of its max")
        check(lf_err <= FWD_ATOL and lb_rel <= BWD_RTOL,
              f"{label}: the embedding_bag yardstick computes another function")
        times["fwd_library_ms"] = median_ms(lib_fwd)
        times["bwd_library_ms"] = median_ms(lib_bwd)
    bounds = {}
    if cost is not None:
        for d in ("fwd", "bwd"):
            bounds[f"{d}_bound_ms"] = cost[d]["bound_ms"]
            bounds[f"{d}_bound_by"] = cost[d]["bound_by"]
    def ms(d, what):
        v = {**times, **bounds}.get(f"{d}_{what}_ms" if what else f"{d}_ms")
        return "n/a" if v is None else f"{v:.4f} ms"

    print(f"kernels: {label} forward {ms('fwd', '')}, plain {ms('fwd', 'plain')}, "
          f"embedding_bag {ms('fwd', 'library')}, bound {ms('fwd', 'bound')}; backward "
          f"{ms('bwd', '')}, plain {ms('bwd', 'plain')}, embedding_bag {ms('bwd', 'library')}, "
          f"bound {ms('bwd', 'bound')} (medians; rows touched "
          f"{cost['touched_rows'] if cost else 'n/a'})")
    return {"fwd_err": fwd_err, "bwd_err": max(dt_err, dp_err), **times, **bounds}


def _fields(r: dict, d: str) -> dict:
    """``hold_pair``'s numbers of one direction ("fwd" or "bwd")."""
    return {"max_abs_err": r[f"{d}_err"], "ms": r[f"{d}_ms"], "plain_ms": r[f"{d}_plain_ms"],
            "bound_ms": r[f"{d}_bound_ms"], "bound_by": r[f"{d}_bound_by"],
            "library_ms": r[f"{d}_library_ms"]}


def _entries(r: dict, names, src: str, functions, lines, launches=(0, 0)) -> list[dict]:
    """The kernels-JSON entries of a forward/backward pair (launches of the
    training paths are filled in after their runs)."""
    return [
        {"name": name, "route": "cuda", "source": src, "function": fn,
         "replaces": f"{TPU}:{line}", "launches": n, **_fields(r, d)}
        for d, name, fn, line, n in zip(("fwd", "bwd"), names, functions, lines, launches)
    ]


def _inputs(dev, g, rows, width, out_dim, p=P_SLICE, pos=None):
    table = torch.rand((rows, width), generator=g, device=dev) * 2.0 - 1.0
    if pos is None:
        pos = torch.rand((p, 3), generator=g, device=dev) * 0.98 + 0.01
    grad = torch.randn((pos.shape[0], out_dim), generator=g, device=dev)
    return table, pos, grad


def cell_pair(hg, layout, label, table, pos, grad) -> dict:
    """K1/K2 at ``layout`` on these inputs, with the yardstick and bounds."""
    return hold_pair(
        label,
        lambda t, p: hg.cell_encode_fwd_cuda(t, p, layout),
        lambda t, p, gr: hg.cell_encode_bwd_cuda(t, p, gr, layout, True),
        lambda t, p: hg.cell_encode_torch(t, p, layout),
        table, pos, grad,
        library=library_pair(hg, table, pos, grad, layout, corner=False),
        cost=work(hg, pos, layout, 2, corner=False),
    )


def corner_pair(hg, layout, feats, label, table, pos, grad) -> dict:
    """K3/K4 at ``layout`` with ``feats`` features a level on these inputs,
    with the yardstick and bounds."""
    return hold_pair(
        label,
        lambda t, p: hg.corner_encode_fwd_cuda(t, p, layout, feats),
        lambda t, p, gr: hg.corner_encode_bwd_cuda(t, p, gr, layout, feats, True),
        lambda t, p: hg.grid_encode_corner_torch(t, p, layout, feats),
        table, pos, grad,
        library=library_pair(hg, table, pos, grad, layout, corner=True),
        cost=work(hg, pos, layout, feats, corner=True),
    )


def kernel_phase(hg, cell_layout, corner_grid, dev, seed: int) -> list[dict]:
    """Every kernel at the shapes its path gives it, against its plain
    version: K1/K2 at the cell slice's layout, K3/K4 at the corner slice's
    (and once at F = 4), K5/K6 (cell v1, served by the cell kernels at a
    uniform layout) through ``grid_encode_flat(mode="cell")``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    print(f"kernels: P={P_SLICE} uniform-random points")

    k12 = cell_pair(
        hg, cell_layout,
        f"K1/K2 cell v2 ({cell_layout.num_levels} levels, {cell_layout.total_rows} rows)",
        *_inputs(dev, g, cell_layout.total_rows, 16, 2 * cell_layout.num_levels),
    )

    def corner(layout, feats, label):
        inputs = _inputs(dev, g, layout.total_rows, feats, feats * layout.num_levels)
        return corner_pair(hg, layout, feats, label, *inputs)

    f = corner_grid.features_per_level
    layout = corner_grid.table_layout()
    k34 = corner(layout, f, f"K3/K4 corner ({layout.num_levels} levels, T={layout.rows[0]}, "
                            f"F={f}, direct {sum(layout.direct)})")
    corner(hg.corner_layout(*CORNER_F4), 4,
           f"K3/K4 corner ({len(CORNER_F4[0])} levels, T={CORNER_F4[1]}, F=4)")

    res, t_v1 = corner_grid.level_resolutions(), corner_grid.table_size
    v1 = hg.uniform_cell_layout(res, t_v1)

    def flat(t, p):
        return hg.grid_encode_flat(t, p, res, t_v1, 2, "cell")

    table, pos, grad = _inputs(dev, g, v1.total_rows, 16, 2 * len(res))
    v1_counts = flat_path_launches(hg, flat, table, pos, grad)
    k56 = hold_pair(
        f"K5/K6 cell v1 ({len(res)} levels, T={t_v1}, direct {sum(v1.direct)})",
        flat, None, lambda t, p: hg.cell_encode_torch(t, p, v1), table, pos, grad,
        library=library_pair(hg, table, pos, grad, v1, corner=False),
        cost=work(hg, pos, v1, 2, corner=False),
    )
    k1_export = export_k1(hg, cell_layout, dev, g)
    cell_fns = ("cell_encode_fwd_kernel", "cell_encode_bwd_kernel")
    entries = (
        _entries(k12, ("cell_encode_fwd", "cell_encode_bwd"), CELL_SRC, cell_fns, (523, 581))
        + _entries(k34, ("corner_encode_fwd", "corner_encode_bwd"), CORNER_SRC,
                   ("corner_encode_fwd_kernel", "corner_encode_bwd_kernel"), (163, 203))
        + _entries(k56, ("cell_v1_encode_fwd", "cell_v1_encode_bwd"), CELL_SRC, cell_fns,
                   (865, 903), (v1_counts["cell_encode_fwd"], v1_counts["cell_encode_bwd"]))
    )
    k1 = entries[0]
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_export["export_max_abs_err"])
    k1.update(k1_export)
    return entries


def export_batch(dev):
    """The first batch of the orchard phase's export (MAX_PROBES probes at
    N = EXPORT_N), placed as ``sample_volume`` places them: -> (positions in
    the unit cube, inside mask). The AABB selector zeroes every probe on or
    outside the box's faces, so the batch holds exact zeros beside values
    just inside the faces."""
    from fruitnerf_tpu_torch.core.math import normalize_aabb_to_unit
    from fruitnerf_tpu_torch.core.samplers import spaced_samples
    from fruitnerf_tpu_torch.export import volume_sampler as vs

    ec = vs.ExportConfig(num_points_per_side=EXPORT_N)
    origins, direction, far = vs.orthographic_ray_grid(ec.aabb, EXPORT_N)
    bundle = vs.probe_bundle(torch.from_numpy(origins[: vs.rays_per_batch(ec)]).to(dev),
                             torch.from_numpy(direction).to(dev), far)
    probes = spaced_samples(bundle, EXPORT_N, spacing="uniform", train=False).positions()
    pos, inside = normalize_aabb_to_unit(probes.reshape(-1, 3), torch.as_tensor(ec.aabb, device=dev))
    check(pos.shape[0] == vs.MAX_PROBES, f"an export batch of {pos.shape[0]} probes")
    return pos.contiguous(), inside


def export_k1(hg, layout, dev, g) -> dict:
    """K1 alone at the export's batch (``export_batch``) against the plain
    version, with the yardstick and the bound."""
    pos, inside = export_batch(dev)
    table = torch.rand((layout.total_rows, 16), generator=g, device=dev) * 2.0 - 1.0
    ref = hg.cell_encode_torch(table, pos, layout)
    err = (hg.cell_encode_fwd_cuda(table, pos, layout) - ref).abs().max().item()
    kept = pos[inside]
    print(f"kernels: K1 at an export batch, P={pos.shape[0]} ({int((~inside).sum())} probes on "
          f"or outside the box zeroed; the others in [{kept.min().item():.6f}, "
          f"{kept.max().item():.6f}]): forward max abs err {err:.3e} (tol {FWD_ATOL:g})")
    check(err <= FWD_ATOL, f"K1 at an export batch: forward error {err} > {FWD_ATOL}")
    cost = work(hg, pos, layout, 2, corner=False)["fwd"]
    ms = median_ms(lambda: hg.cell_encode_fwd_cuda(table, pos, layout), iters=10)
    plain_ms = median_ms(lambda: hg.cell_encode_torch(table, pos, layout), iters=10)
    lib_fwd, _ = library_pair(hg, table, pos, None, layout, corner=False)
    lib_err = (lib_fwd() - ref).abs().max().item()
    check(lib_err <= FWD_ATOL, f"the export-batch yardstick differs by {lib_err}")
    lib_ms = median_ms(lib_fwd, iters=10)
    print(f"kernels: K1 at an export batch {ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag "
          f"{lib_ms:.4f} ms (err {lib_err:.3e}), bound {cost['bound_ms']:.4f} ms "
          f"({cost['bound_by']}) (median)")
    return {"export_probes": pos.shape[0], "export_max_abs_err": err, "export_ms": ms,
            "export_plain_ms": plain_ms, "export_bound_ms": cost["bound_ms"],
            "export_bound_by": cost["bound_by"], "export_library_ms": lib_ms}


def step_layout(pair, layout, row_width: int, out_dim: int, captured: list, dev, seed: int,
                label: str) -> dict:
    """A kernel pair (``pair(table, pos, grad, label)``: ``cell_pair`` or
    ``corner_pair``) at the positions one train step gives it, captured
    from a slice's last step: the fine samples (ray-major, 48 consecutive
    samples a ray) and the sparsity points, each its own launch, as the
    step launches them; random table and output gradient."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for name, pos in zip(("fine", "sparsity"), captured):
        table, pos, grad = _inputs(dev, g, layout.total_rows, row_width, out_dim, pos=pos)
        r = pair(table, pos, grad, f"{label} at the step's {name} points, P={pos.shape[0]}")
        out[name] = {"points": pos.shape[0], **r}
    return out


def flat_path_launches(hg, flat, table, pos, grad) -> dict:
    """Cell v1's path: no training path reaches it, only a direct call of
    ``grid_encode_flat(mode="cell")``. One forward and autograd backward
    through that entry, counted alone; both kernels must launch."""
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    flat(t_, p_).backward(grad)
    torch.cuda.synchronize()
    counts = dict(hg.LAUNCHES)
    print(f"kernels: cell v1 path, one forward and backward through "
          f"grid_encode_flat(mode='cell'): launches {counts}")
    check(counts["cell_encode_fwd"] >= 1, "grid_encode_flat(mode='cell') skipped K5")
    check(counts["cell_encode_bwd"] >= 1, "grid_encode_flat(mode='cell') skipped K6")
    check(t_.grad is not None and p_.grad is not None, "the cell v1 path gave no gradient")
    return counts


def small_config(num_images: int):
    """The preset shrunk to a few levels, rays and samples, float32 compute."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf
    from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig

    cfg = apply_overrides(
        fruit_nerf(num_images, compute_dtype=torch.float32),
        {"sparsity_loss": 0.005, "sparsity_points": 256, "train_rays_per_batch": 256},
    )
    m = cfg.model
    grid = GridEncodingConfig(
        num_levels=6, table_size=2048, base_res=8, max_res=512,
        mid_table_size=1024, fine_levels=2,
    )
    nets = tuple(dataclasses.replace(n, compute_dtype=torch.float32) for n in m.proposal_nets)
    model = dataclasses.replace(
        m, num_proposal_samples=(32, 16), num_nerf_samples=16, proposal_nets=nets,
        field=dataclasses.replace(m.field, grid=grid),
    )
    return dataclasses.replace(cfg, model=model)


def parity_phase(scene, dev, seed: int):
    """One small step on the GPU (kernels) against the CPU (plain version),
    same parameters and draws: every loss term, and the colour MLP's
    gradient. The grid's and the camera's gradients are not compared here:
    float32 rounding of the far samples' positions, amplified by the
    piecewise spacing's 1/(2-2s), moves a few points across cell faces, so
    they read other rows on the two devices. The kernel phase holds K2 to
    the plain version at fixed positions instead."""
    from fruitnerf_tpu_torch.bridge import tree_map
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import compute_loss, draw_step, init_train_state

    n = scene["images"].shape[0]
    cfg = small_config(n)
    cpu = torch.device("cpu")
    results = []
    for device in (cpu, dev):
        data = dataset_from_scene(scene, device)
        gen = torch.Generator(device=cpu).manual_seed(seed)
        state = init_train_state(cfg, n, cpu, generator=gen)
        draws = draw_step(cfg, dataset_from_scene(scene, cpu), gen)
        if device != cpu:
            state = init_train_state(
                cfg, n, device,
                params=tree_map(state.params, lambda t: t.detach().to(device)),
            )
            draws = dataclasses.replace(
                draws, **{f.name: tree_map(getattr(draws, f.name), lambda t: t.to(device))
                          for f in dataclasses.fields(draws)},
            )
        total, losses, _ = compute_loss(state, data, cfg, draws)
        total.backward()
        terms = {"total": total.item(), **{k: v.item() for k, v in losses.items()}}
        results.append((terms, state.params["model"]["field"]["color_mlp"]["w0"].grad.cpu()))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu}
    grad_rel = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"parity: small step loss gpu {l_gpu['total']:.7f} cpu {l_cpu['total']:.7f}; "
          "rel err " + " ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {LOSS_RTOL:g})")
    print(f"parity: color_mlp.w0 grad rel err {grad_rel:.2e} (tol {GRAD_RTOL:g})")
    check(max(rel.values()) <= LOSS_RTOL, f"small-step losses differ: {rel}")
    check(grad_rel <= GRAD_RTOL, f"small-step color_mlp grad differs: {grad_rel}")


@contextlib.contextmanager
def captured_positions(sink: list, entry: str = "cell_encode", when=lambda: True):
    """Record a copy of the positions that ``fields/encodings.grid_encode``
    hands to ``entry`` (``cell_encode``, or ``grid_encode_flat`` in corner
    mode) in the block, at each call made with gradients on while
    ``when()`` holds."""
    from fruitnerf_tpu_torch.fields import encodings

    real = getattr(encodings, entry)

    def spy(table, positions, *args):
        if torch.is_grad_enabled() and when():
            sink.append(positions.detach().clone())
        return real(table, positions, *args)

    setattr(encodings, entry, spy)
    try:
        yield
    finally:
        setattr(encodings, entry, real)


def slice_phase(scene, dev, steps: int, seed: int, hg, name: str):
    """The cell-mode training steps, by hand. Returns the launch counts and
    the positions of the last step's two grid encodings (fine samples,
    sparsity points)."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, render_camera, train_step

    n = scene["images"].shape[0]
    data = dataset_from_scene(scene, dev)
    cfg = apply_overrides(fruit_nerf(n), {"sparsity_loss": 0.005})
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, n, dev, generator=gen)
    rays = cfg.train_rays_per_batch
    print(f"slice: fruit_nerf grid, {n} cameras at {data.image_shape}, "
          f"{rays} rays/step, sparsity 0.005, {steps} steps")

    hg.reset_launch_counts()
    warm = min(20, steps // 2)
    history = []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        if i == steps - 1:
            captured = []
            with captured_positions(captured):
                m = train_step(state, data, cfg, gen)
        else:
            m = train_step(state, data, cfg, gen)
        history.append(torch.stack([m["total_loss"], m["rgb_loss"], m["semantics_loss"],
                                    m["interlevel_loss"], m["sparsity_loss"], m["psnr"]]))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    train_counts = dict(hg.LAUNCHES)
    hist = torch.stack(history).cpu()
    steady = (steps - warm) / (t_end - t_warm)
    print(f"slice: {steps / (t_end - t_start):.3f} steps/s overall, steady (after step "
          f"{warm}) {steady:.3f} steps/s = {steady * rays:.1f} rays/s on {name}")
    print(f"slice: first total loss {hist[0, 0]:.5f}, last {hist[-1, 0]:.5f}; "
          f"last rgb {hist[-1, 1]:.5f} semantics {hist[-1, 2]:.5f} "
          f"interlevel {hist[-1, 3]:.5f} sparsity {hist[-1, 4]:.6f}")
    check(bool(torch.isfinite(hist[:, :5]).all()), "a loss is not finite")
    k = min(20, steps // 2)
    psnr_first, psnr_last = hist[:k, 5].mean().item(), hist[-k:, 5].mean().item()
    print(f"slice: mean train PSNR first {k} steps {psnr_first:.3f} dB, last {k} "
          f"{psnr_last:.3f} dB")
    check(psnr_last > psnr_first, "PSNR did not rise")
    print(f"slice: launches in {steps} steps: {train_counts}")
    check(train_counts["cell_encode_fwd"] >= 2 * steps, "a step skipped the forward kernel")
    check(train_counts["cell_encode_bwd"] >= steps, "a step skipped the backward kernel")
    shapes = [tuple(c.shape) for c in captured]
    samples = rays * cfg.model.num_nerf_samples
    print(f"slice: the last step encoded {shapes} points")
    check(shapes == [(samples, 3), (cfg.model.sparsity_num_points, 3)],
          f"the last step's grid encodings took {shapes} points")

    train_idx = set(data.train_indices.tolist())
    held = [i for i in range(n) if i not in train_idx]
    check(bool(held), "no held-out camera")
    cam = held[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_camera(state.params, data.cameras, cam, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rgb = out["rgb"]
    h, w = data.image_shape
    check(tuple(rgb.shape) == (h, w, 3), f"render shape {tuple(rgb.shape)}")
    check(bool(torch.isfinite(rgb).all()), "render is not finite")
    gt = data.images[cam].float() / 255.0
    psnr = -10.0 * math.log10(max(torch.mean((rgb - gt) ** 2).item(), 1e-10))
    print(f"slice: held-out camera {cam} render {h}x{w} in {dt:.3f} s, PSNR {psnr:.3f} dB")
    return dict(hg.LAUNCHES), captured


def corner_config(num_images: int):
    """The full-width fruit_nerf preset with sparsity 0.005, its grid in
    corner mode (uniform tables: corner mode has no two-tier caps)."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf

    cfg = apply_overrides(fruit_nerf(num_images), {"sparsity_loss": 0.005})
    m = cfg.model
    grid = dataclasses.replace(m.field.grid, mode="corner", mid_table_size=None)
    field = dataclasses.replace(m.field, grid=grid)
    return dataclasses.replace(cfg, model=dataclasses.replace(m, field=field))


LOSS_KEYS = ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss")


def corner_slice_phase(scene, dev, steps: int, seed: int, hg, name: str):
    """``train_loop`` on the corner-mode config: log every step, eval and
    checkpoint every 100 steps; then the manifest, and a resume into a
    fresh state that must equal the trained one. Returns the launch counts
    and the positions of the last step's two grid encodings (fine samples,
    sparsity points)."""
    from fruitnerf_tpu_torch.bridge import tree_leaves
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine import checkpoints as ck
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, render_camera, train_loop
    from fruitnerf_tpu_torch.utils.writer import MetricWriter

    n = scene["images"].shape[0]
    data = dataset_from_scene(scene, dev)
    cfg = dataclasses.replace(corner_config(n), max_iters=steps, steps_per_log=1,
                              steps_per_eval=100, steps_per_save=100)
    grid = cfg.model.field.grid
    train_idx = set(data.train_indices.tolist())
    held = [i for i in range(n) if i not in train_idx]
    check(bool(held), "no held-out camera")
    rays = cfg.train_rays_per_batch
    print(f"corner: fruit_nerf grid in corner mode, {grid.num_levels} levels x T="
          f"{grid.table_size} x F={grid.features_per_level} (table {list(grid.table_shape)}), "
          f"{rays} rays/step, sparsity 0.005, train_loop to {steps} steps, eval cameras {held}")

    with tempfile.TemporaryDirectory() as run_dir:
        run = Path(run_dir)
        writer = MetricWriter(run / "metrics.jsonl", also_print=False)
        gen = torch.Generator(device=dev).manual_seed(seed)
        timings: dict = {}
        captured, last_step = [], [False]

        def arm(it, state, metrics):  # after step `it`: is the next one the last?
            last_step[0] = it == steps - 1

        hg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_positions(captured, "grid_encode_flat", lambda: last_step[0]):
            state = train_loop(cfg, data, eval_indices=held, generator=gen, writer=writer,
                               checkpoint_dir=run / "checkpoints", timings=timings,
                               callbacks=(arm,))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(hg.LAUNCHES)
        writer.close()
        records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in records if "total_loss" in r]
        evals = [r for r in records if "eval_psnr" in r]
        rate = steps / timings["train_s"]
        print(f"corner: {rate:.3f} steps/s = {rate * rays:.1f} rays/s over train_s "
              f"{timings['train_s']:.3f} s (with a host sync every step, for the log); "
              f"wall {wall:.3f} s, "
              f"eval_s {timings['eval_s']:.3f}, save_s {timings['save_s']:.3f} on {name}")
        check(len(train) == steps, f"{len(train)} logged steps of {steps}")
        check(all(math.isfinite(r[k]) for r in train for k in LOSS_KEYS), "a loss is not finite")
        k = 20
        psnr_first = sum(r["psnr"] for r in train[:k]) / k
        psnr_last = sum(r["psnr"] for r in train[-k:]) / k
        print(f"corner: first total loss {train[0]['total_loss']:.5f}, last "
              f"{train[-1]['total_loss']:.5f}; mean train PSNR first {k} steps "
              f"{psnr_first:.3f} dB, last {k} {psnr_last:.3f} dB")
        check(psnr_last > psnr_first, "corner PSNR did not rise")
        print(f"corner: launches in {steps} steps and {len(evals)} evals: {counts}")
        check(counts["corner_encode_fwd"] >= 2 * steps, "a step skipped the corner forward kernel")
        check(counts["corner_encode_bwd"] >= steps, "a step skipped the corner backward kernel")
        check(counts["cell_encode_fwd"] == counts["cell_encode_bwd"] == 0,
              "the corner path launched a cell kernel")
        shapes = [tuple(c.shape) for c in captured]
        samples = rays * cfg.model.num_nerf_samples
        print(f"corner: the last step encoded {shapes} points")
        check(shapes == [(samples, 3), (cfg.model.sparsity_num_points, 3)],
              f"the last step's grid encodings took {shapes} points")
        check(len(evals) == steps // 100, f"{len(evals)} evals in {steps} steps")
        for r in evals:
            print("corner: eval at step {step}: PSNR {eval_psnr:.3f} dB, SSIM {eval_ssim:.4f}, "
                  "IoU {eval_iou:.4f}, {eval_num_rays_per_sec:.1f} rays/s".format(**r))
            check(all(math.isfinite(v) for key, v in r.items() if key.startswith("eval_")),
                  f"eval stats not finite: {r}")
            check(-1.0 <= r["eval_ssim"] <= 1.0, f"SSIM out of [-1, 1]: {r['eval_ssim']}")

        ck.write_manifest(run, cfg.preset, np.eye(4)[:3], 1.0, np.array([[-1.0] * 3, [1.0] * 3]),
                          n, grid, extra={"config_overrides": {"sparsity_loss": 0.005}})
        manifest = ck.read_manifest(run)
        # raises if the rebuilt layout differs from the recorded one or from grid's
        rebuilt = ck.grid_from_manifest(manifest, expect=grid)
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, field=dataclasses.replace(cfg.model.field, grid=rebuilt)))
        gen2 = torch.Generator(device=dev).manual_seed(seed + 1)
        fresh = init_train_state(rcfg, n, dev, generator=gen2)
        restored, resumed = ck.resume_from_latest(run / "checkpoints", fresh, gen2)
        check(resumed and restored.step == steps, f"resumed at step {restored.step}")
        pairs = list(zip(tree_leaves(state.params), tree_leaves(restored.params)))
        same = all(torch.equal(a, b) for a, b in pairs)
        check(same, "a restored parameter differs from the trained one")
        check(torch.equal(gen.get_state(), gen2.get_state()), "the generator state differs")
        out_a = render_camera(state.params, data.cameras, held[0], rcfg)["rgb"]
        out_b = render_camera(restored.params, data.cameras, held[0], rcfg)["rgb"]
        diff = (out_a - out_b).abs().max().item()
        print(f"corner: manifest grid entry rebuilds {rebuilt.mode} {list(rebuilt.table_shape)}; "
              f"resumed at step {restored.step}, {len(pairs)} parameters equal; held-out "
              f"camera {held[0]} render max abs diff {diff:g}")
        check(diff == 0.0, "the restored state renders differently")
    return counts, captured


@contextlib.contextmanager
def counted_calls(module, attr: str, hg, sink: dict):
    """Wrap ``module.attr`` for the block: each call starts with every
    launch count at 0 and appends the counts after it to ``sink[attr]``."""
    real = getattr(module, attr)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        hg.reset_launch_counts()
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            sink.setdefault(attr, []).append(dict(hg.LAUNCHES))

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, real)


ORCHARD = dict(num_fruits=120, num_cameras=200, image_size=256, seed=7)  # bench.py's orchard


def orchard_phase(dev, iters: int, export_n: int, hg, name: str):
    """The fruit-counting main path through its entry point,
    ``scripts.orchard_e2e.main``, on the bench orchard at full width; then a
    second call on the same directory, which resumes at the final step.
    Returns the K1/K2 launches summed over the counted calls of both."""
    from fruitnerf_tpu_torch.data import synthetic
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.export import volume_sampler as vs
    from fruitnerf_tpu_torch.scripts import count, orchard_e2e

    lib = count.native_library()
    check(lib is not None,
          "the native counting library did not build or load (g++ needed); large clouds "
          "would reach the JAX-only device DBSCAN")
    print(f"orchard: native counting library {lib.name} loaded")

    cfg_scene = synthetic.orchard_config(**ORCHARD)
    pairs = synthetic.ray_sphere_pairs(cfg_scene)
    check(pairs > synthetic.NUMPY_MAX_PAIRS, f"{pairs} ray-sphere pairs take the numpy tracer")
    # render afresh, through the torch renderer, into the cache orchard_e2e.main reads
    cache = synthetic.scene_cache_path(cfg_scene)
    cache.unlink(missing_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = synthetic.cached_render_scene(cfg_scene, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(cache.exists(), f"the scene was not cached at {cache}")
    mask_np = synthetic.numpy_fruit_mask(cfg_scene, scene["poses"][0])
    flips = float(np.mean(mask_np != (scene["masks"][0] > 0.5)))
    print(f"orchard: scene {cfg_scene.num_fruits} fruits + {cfg_scene.num_leaves} leaves, "
          f"{len(scene['poses'])} cameras at {cfg_scene.image_size}^2 ({pairs} ray-sphere pairs "
          f"a camera) rendered by the torch renderer and cached in {dt:.3f} s; camera 0's fruit "
          f"mask differs from the numpy tracer's on {flips:.2e} of its pixels (tol 2e-3)")
    check(flips <= 2e-3, f"the torch renderer's mask differs on {flips} of camera 0")

    parser = argparse.ArgumentParser()
    orchard_e2e.add_args(parser)
    with tempfile.TemporaryDirectory() as run_dir:
        args = parser.parse_args([
            "--num-fruits", str(ORCHARD["num_fruits"]), "--num-cameras", str(ORCHARD["num_cameras"]),
            "--image-size", str(ORCHARD["image_size"]), "--seed", str(ORCHARD["seed"]),
            "--iters", str(iters), "--sparsity-loss", "0.005", "--export-n", str(export_n),
            "--output-dir", run_dir,
        ])
        reports, counts = [], {}
        for call in range(2):
            with counted_calls(trainer, "train_loop", hg, counts), \
                    counted_calls(vs, "sample_volume", hg, counts):
                reports.append(orchard_e2e.main(args))
        first, second = reports
    batches = math.ceil(export_n**2 / vs.rays_per_batch(vs.ExportConfig(num_points_per_side=export_n)))

    steps = first["steps_run"]
    rays = first["train_rays_per_sec_train_only"]
    check(first["device"] == second["device"] == name,
          f"the reports name {first['device']!r} and {second['device']!r}, not {name!r}")
    print(f"orchard: reports taken on {first['device']}; scene {first['render_scene_s']:.3f} s "
          f"in orchard_e2e.main (its cache); "
          f"train {steps} steps: {rays / 4096:.3f} steps/s = {rays:.1f} rays/s over train_s "
          f"{first['loop_timings']['train_s']:.3f} s (overall {first['train_rays_per_sec']:.1f} "
          f"rays/s over {first['train_s']:.3f} s with evals and saves) on {name}")
    check(steps == iters, f"ran {steps} steps of {iters}")
    ev = first["eval"]
    print(f"orchard: eval over the held-out cameras: PSNR {ev['psnr']:.3f} dB, SSIM "
          f"{ev['ssim']:.4f}, IoU {ev['iou']:.4f}, {ev['num_rays_per_sec']:.1f} rays/s "
          f"({first['eval_s']:.3f} s)")
    check(all(math.isfinite(v) for v in ev.values()), f"eval stats not finite: {ev}")
    check(-1.0 <= ev["ssim"] <= 1.0, f"SSIM out of [-1, 1]: {ev['ssim']}")
    train_counts, export_counts = counts["train_loop"][0], counts["sample_volume"][0]
    print(f"orchard: launches in train_loop ({steps} steps, evals every 500): {train_counts}")
    check(train_counts["cell_encode_fwd"] >= 2 * steps, "a train step skipped K1")
    check(train_counts["cell_encode_bwd"] >= steps, "a train step skipped K2")
    pts = first["export_points"]
    print(f"orchard: export N={export_n} ({export_n**3} probes, {batches} batches) in "
          f"{first['export_s']:.3f} s = {first['export_probes_per_sec']:.1f} probes/s; points "
          f"{pts}; launches {export_counts}")
    check(export_counts["cell_encode_fwd"] == batches,
          f"export launched K1 {export_counts['cell_encode_fwd']} times for {batches} batches")
    check(export_counts["cell_encode_bwd"] == 0, "export launched K2")
    check(pts["density"] > 0, "the density cloud is empty")
    for cloud, c in first["counting"].items():
        if "error" in c:
            print(f"orchard: count on {cloud}: {c['error']}")
            check(pts[cloud] == 0, f"{cloud} has points but no count")
        else:
            print(f"orchard: count on {cloud}: {c['count']}/{first['gt_count']} "
                  f"({c['count_error_pct']:.2f}% error), F1 {c['F1']:.4f}, precision "
                  f"{c['precision']:.4f}, recall {c['recall']:.4f}")
            check(c["count"] >= 0 and 0.0 <= c["F1"] <= 1.0, f"count on {cloud}: {c}")
    print(f"orchard: count_s {first['count_s']:.3f} s")

    print(f"orchard: second call resumed at step {second.get('resumed_from_step')}, ran "
          f"{second['steps_run']} steps; train_rays_per_sec {second['train_rays_per_sec']}; "
          f"export points {second['export_points']}")
    check(second.get("resumed_from_step") == iters and second["steps_run"] == 0,
          "the second call did not resume at the final step")
    check(second["train_rays_per_sec"] is None and second["train_rays_per_sec_train_only"] is None,
          "a zero-step run reported a rate")
    check(second["export_points"] == pts, "the resumed run exported other clouds")
    check(counts["sample_volume"][1]["cell_encode_fwd"] == batches, "the second export's K1 count")
    runs = counts["train_loop"] + counts["sample_volume"]
    return {k: sum(c[k] for c in runs) for k in ("cell_encode_fwd", "cell_encode_bwd")}


def _other_kernels(lib, hg, corner: bool):
    """Wrappers of another build's cell_encode or corner_encode pair (the
    same C interface), uncounted: -> (fwd(table, pos, layout, f),
    bwd(table, pos, grad, layout, f)); cell mode has f = 2."""
    kind = "corner" if corner else "cell"

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(table, pos, layout, f):
        out = torch.empty((pos.shape[0], f * layout.num_levels), device=pos.device)
        head = (pos.data_ptr(), table.data_ptr(), out.data_ptr(), pos.shape[0])
        levels = (layout.num_levels, *hg._level_arrays(layout), stream())
        err = (lib.corner_encode_fwd(*head, f, *levels) if corner
               else lib.cell_encode_fwd(*head, *levels))
        check(err == 0, f"the other {kind}_encode_fwd: CUDA error {err}")
        return out

    def bwd(table, pos, grad, layout, f):
        dtable, dpos = torch.zeros_like(table), torch.empty_like(pos)
        head = (pos.data_ptr(), table.data_ptr(), grad.data_ptr(), dtable.data_ptr(),
                dpos.data_ptr(), pos.shape[0])
        levels = (layout.num_levels, *hg._level_arrays(layout), stream())
        err = (lib.corner_encode_bwd(*head, f, 1, *levels) if corner
               else lib.cell_encode_bwd(*head, 1, *levels))
        check(err == 0, f"the other {kind}_encode_bwd: CUDA error {err}")
        return dtable, dpos

    return fwd, bwd


def _this_kernels(hg, corner: bool):
    """This checkout's plain version and kernels in ``_other_kernels``'
    signatures: -> (plain, fwd, bwd)."""
    if corner:
        return (hg.grid_encode_corner_torch, hg.corner_encode_fwd_cuda,
                lambda t, p, gr, layout, f: hg.corner_encode_bwd_cuda(t, p, gr, layout, f, True))
    return (lambda t, p, layout, f: hg.cell_encode_torch(t, p, layout),
            lambda t, p, layout, f: hg.cell_encode_fwd_cuda(t, p, layout),
            lambda t, p, gr, layout, f: hg.cell_encode_bwd_cuda(t, p, gr, layout, True))


def cell_ab_cases(layout, captured: list, dev, seed: int) -> dict:
    """K1/K2's A/B inputs: uniform-random points, the cell step's fine and
    sparsity points, and (K1 alone) an export batch."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, nl = layout.total_rows, layout.num_levels
    cases = {"random": (layout, 2, *_inputs(dev, g, rows, 16, 2 * nl))}
    for name, pos in zip(("step_fine", "step_sparsity"), captured):
        cases[name] = (layout, 2, *_inputs(dev, g, rows, 16, 2 * nl, pos=pos))
    export_pos, _ = export_batch(dev)
    table = torch.rand((rows, 16), generator=g, device=dev) * 2.0 - 1.0
    cases["export"] = (layout, 2, table, export_pos, None)
    return cases


def corner_ab_cases(hg, grid, captured: list, dev, seed: int) -> dict:
    """K3/K4's A/B inputs: uniform-random points and the corner step's fine
    and sparsity points, at the corner slice's layout (F = 2) and at the
    kernel phase's F = 4 layout."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    cases = {}
    for layout, f in ((grid.table_layout(), grid.features_per_level),
                      (hg.corner_layout(*CORNER_F4), 4)):
        rows, width = layout.total_rows, f * layout.num_levels
        cases[f"random_f{f}"] = (layout, f, *_inputs(dev, g, rows, f, width))
        for name, pos in zip(("step_fine", "step_sparsity"), captured):
            cases[f"{name}_f{f}"] = (layout, f, *_inputs(dev, g, rows, f, width, pos=pos))
    return cases


def ab_phase(hg, old_source: Path, corner: bool, cases: dict) -> dict:
    """A kernel pair of this checkout ("new") against another build of the
    same source ("old", built apart) and the plain version, in turns plain,
    old, new, new, old, plain, on each case (name -> (layout, F, table,
    positions, output gradient, or None to time the forward alone)). Each
    is held to the plain version first; each case also carries its bounds
    and the ``embedding_bag`` yardstick's times."""
    lib, info = hg.build_library([old_source], Path(hg._BUILD) / "ab")
    print(f"ab: {old_source} built in {info.seconds:.2f} s")
    old_fwd, old_bwd = _other_kernels(lib, hg, corner)
    plain, new_fwd, new_bwd = _this_kernels(hg, corner)
    results = {}
    for name, (layout, f, table, pos, grad) in cases.items():
        iters = 10 if pos.shape[0] > P_SLICE else 30
        fns = {"fwd": {"plain": lambda: plain(table, pos, layout, f),
                       "old": lambda: old_fwd(table, pos, layout, f),
                       "new": lambda: new_fwd(table, pos, layout, f)}}
        ref = fns["fwd"]["plain"]()
        errs = {"fwd_old": (fns["fwd"]["old"]() - ref).abs().max().item(),
                "fwd_new": (fns["fwd"]["new"]() - ref).abs().max().item()}
        lib_fwd, lib_bwd = library_pair(hg, table, pos, grad, layout, corner)
        errs["fwd_library"] = (lib_fwd() - ref).abs().max().item()
        if grad is not None:
            t_ = table.clone().requires_grad_(True)
            p_ = pos.clone().requires_grad_(True)
            plain_out = plain(t_, p_, layout, f)
            fns["bwd"] = {
                "plain": lambda: torch.autograd.grad(plain_out, (t_, p_), grad, retain_graph=True),
                "old": lambda: old_bwd(table, pos, grad, layout, f),
                "new": lambda: new_bwd(table, pos, grad, layout, f)}
            dt_p, dp_p = fns["bwd"]["plain"]()
            for side in ("old", "new"):
                dt, dp = fns["bwd"][side]()
                errs[f"bwd_{side}"] = max(((dt - dt_p).abs().max() / dt_p.abs().max()).item(),
                                          ((dp - dp_p).abs().max() / dp_p.abs().max()).item())
            errs["bwd_library"] = ((lib_bwd() - dt_p).abs().max() / dt_p.abs().max()).item()
        print(f"ab: {name} P={pos.shape[0]} F={f} errors {errs}")
        for k, e in errs.items():
            check(e <= (FWD_ATOL if k.startswith("fwd") else BWD_RTOL), f"ab {name} {k}: {e}")
        cost = work(hg, pos, layout, f, corner)
        row = {"points": pos.shape[0], "features": f, "errors": errs}
        for d, sides in fns.items():
            times = {"plain": [], "old": [], "new": []}
            for side in ("plain", "old", "new", "new", "old", "plain"):
                times[side].append(median_ms(sides[side], iters=iters))
            lib_ms = median_ms(lib_fwd if d == "fwd" else lib_bwd, iters=iters)
            row[d] = {**times, "library": lib_ms, "bound": cost[d]["bound_ms"],
                      "bound_by": cost[d]["bound_by"]}
            print(f"ab: {name} {d} ms (median of {iters}) plain {times['plain']} old "
                  f"{times['old']} new {times['new']}; embedding_bag {lib_ms:.4f}, bound "
                  f"{cost[d]['bound_ms']:.4f} ({cost[d]['bound_by']})")
        results[name] = row
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400, help="steps of each slice")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab-cell-source", type=Path, default=None,
                    help="another cell_encode.cu (for example the parent commit's): run only "
                         "the cell slice, to capture a step's positions, and time its K1/K2 "
                         "against this checkout's")
    ap.add_argument("--ab-corner-source", type=Path, default=None,
                    help="another corner_encode.cu (for example the parent commit's): run only "
                         "the corner slice, to capture a step's positions, and time its K3/K4 "
                         "against this checkout's (with --ab-cell-source, both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")

    from fruitnerf_tpu_torch.configs import fruit_nerf
    from fruitnerf_tpu_torch.data.builder import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.ops import hash_grid as hg

    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    build_phase(hg)
    cell_layout = fruit_nerf(1).model.field.grid.cell_layout()
    scene = render_scene(SyntheticSceneConfig(image_size=128, num_cameras=24, seed=args.seed),
                         device=dev)

    corner_grid = corner_config(1).model.field.grid
    if args.ab_cell_source is not None or args.ab_corner_source is not None:
        ab = {}
        if args.ab_cell_source is not None:
            _, captured = slice_phase(scene, dev, args.steps, args.seed, hg, name)
            ab["cell"] = ab_phase(hg, args.ab_cell_source, False,
                                  cell_ab_cases(cell_layout, captured, dev, args.seed))
        if args.ab_corner_source is not None:
            _, captured = corner_slice_phase(scene, dev, args.steps, args.seed, hg, name)
            ab["corner"] = ab_phase(hg, args.ab_corner_source, True,
                                    corner_ab_cases(hg, corner_grid, captured, dev, args.seed))
        print(json.dumps({"ab": ab}))
        print(card)
        return 0

    kernels = kernel_phase(hg, cell_layout, corner_grid, dev, args.seed)
    parity_phase(scene, dev, args.seed)
    cell_counts, captured = slice_phase(scene, dev, args.steps, args.seed, hg, name)
    step12 = step_layout(lambda t, p, gr, label: cell_pair(hg, cell_layout, label, t, p, gr),
                         cell_layout, 16, 2 * cell_layout.num_levels, captured, dev, args.seed,
                         "K1/K2")
    corner_counts, captured = corner_slice_phase(scene, dev, args.steps, args.seed, hg, name)
    corner_layout, f = corner_grid.table_layout(), corner_grid.features_per_level
    step34 = step_layout(
        lambda t, p, gr, label: corner_pair(hg, corner_layout, f, label, t, p, gr),
        corner_layout, f, f * corner_layout.num_levels, captured, dev, args.seed, "K3/K4")
    orchard_counts = orchard_phase(dev, ORCHARD_ITERS, EXPORT_N, hg, name)
    for k in kernels:  # K5/K6's launches were counted on their own path, in the kernel phase
        if k["name"].startswith("corner_encode"):
            k["launches"] = corner_counts[k["name"]]
        elif k["name"].startswith("cell_encode"):
            k["launches"] = cell_counts[k["name"]] + orchard_counts[k["name"]]
    # K1/K2 and K3/K4 at their step's positions
    for pair, step in ((kernels[0:2], step12), (kernels[2:4], step34)):
        for k, d in zip(pair, ("fwd", "bwd")):
            k["step"] = {at: {"points": r["points"], **_fields(r, d)} for at, r in step.items()}
            k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in k["step"].values()))
    check("jax" not in sys.modules, "the port imported jax")
    jax_package = sorted(m for m in sys.modules
                         if m == "fruitnerf_tpu" or m.startswith("fruitnerf_tpu."))
    check(not jax_package, f"the port imported the JAX package: {jax_package}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
