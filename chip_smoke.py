#!/usr/bin/env python3
"""Drive the PyTorch port once on an NVIDIA GPU: build the CUDA kernels from
this checkout, hold each against its plain PyTorch version, train the
full-width ``fruit_nerf`` grid preset (cell mode, by hand) and its corner-mode
grid (through ``train_loop``, with evals and checkpoints) for a few hundred
steps each on a synthetic scene, and resume and render; then run the
fruit-counting main path, ``orchard-e2e``, on the bench orchard, with the
grid variant and with the parity variant (the reference's hash-grid
network), train the smoke preset through the ``train`` entry point, run
the disk capture workflow (train --data <dir>, eval, render, export,
count) on the bench orchard written as a capture, take a raw capture
through process-data into the big, huge and tpu training configurations,
and run the tools (suggest-crop, the RGB point cloud, the viewer, the
device DBSCAN engine, speed-probe, profiling) on those runs; then the
scale-out layer: K1-K4 with a scene axis, the multi-scene campaign, data
parallelism over torch.distributed and --mesh.

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
           pairs; camera 0's mask held to the numpy tracer's), the first
           ORCHARD_ITERS full-width steps of an ORCHARD_SCHEDULE-step run
           (its learning rates, the default train seed), sparsity 0.005, an
           export at N = COUNT_EXPORT_N and the counting cascade (the native
           counting library must load). Checks that the reports name the
           card, K1/K2 launches in training (>= 2 and >= 1 a step) and K1's
           in export (one a batch), a non-empty density cloud, finite eval
           stats, and that a semantic cloud counts (count_criterion: more
           than half its points within 2 fruit radii of a GT centre, a count
           in [1, 3 x GT]); then a second call on the same directory, which
           must resume at the final step, run zero steps, report null rates
           and export the same clouds. The logged losses must be finite and
           the train PSNR rise
  hash     K3/K4 at the parity variant's three hash layouts (the main
           field's 16 levels x 2^19 entries, a 64 MiB table; two 5-level
           2^17-entry proposal fields) at uniform-random points: P_SLICE for
           the main field, a step's proposal samples (1,048,576 and 393,216)
           for the others, with bounds and yardstick
  orchard parity
           the orchard phase with --variant parity for PARITY_ITERS steps
           (its own schedule, an export at N = EXPORT_N, no count checked):
           K3/K4 launches in train_loop and in export must equal what the
           config predicts (predicted_hash_launches); the last step's four
           hash encodings are captured and K3/K4 held and timed at them
  smoke    scripts.train.main --preset fruit_nerf_smoke --data synthetic
           --max-iters SMOKE_ITERS: finite losses, train PSNR rising, a
           final eval, K3/K4 launches as predicted; then two runs of
           REPEAT_STEPS steps from one seed on the same draws
           (scripts/step_bench.py:two_runs), which must be bitwise equal in
           every loss and parameter
  disk     the bench orchard written as a capture tree (transforms.json,
           explicit val split, an applied_scale of APPLIED_SCALE, an
           images_2/ level; PNGs through Pillow): host seconds to parse and
           load the frames, and to load CAPTURE_FRAMES frames at 1200x900;
           scripts.train.main --data <tree> for DISK_ITERS full-width steps
           (the manifest's transform and scale must equal a fresh parse, K1/K2
           launches equal predicted_cell_launches), then eval with a tiny
           LPIPS npz, render of a val camera (five panels read back), a probe
           of the field at the fruits and the background, export in a crop
           box at DISK_THRESHOLDS (more than half the fruit cloud within two
           fruit radii of a GT centre) and count (in [1, 3 x GT])
  presets  the bench orchard at PRESET_CAMERAS cameras written as a raw
           capture and run through process-data --num-downscales 1 (its
           transforms.json must equal a fresh merge, images_2/ and
           semantics_2/ half size); on that capture, through the train,
           eval, export and count entry points:
           big   train --preset fruit_nerf_big (grid variant, full width,
                 RAdam, 200 of the train images) for BIG_ITERS steps with
                 sparsity 0.005: 200 train images, the fields group on
                 RAdam, finite losses, train PSNR rising, K1/K2 launches
                 equal predicted_cell_launches; eval; the probe; export in
                 DISK_BOX and count, checked as the disk phase's; rays/s,
                 peak memory, process-data, train, export and count seconds
           huge  train --preset fruit_nerf_huge --variant parity (full
                 width) for HUGE_ITERS steps: finite losses, train PSNR
                 rising, K3/K4 launches equal predicted_hash_launches; eval;
                 export; rays/s and peak memory
           tpu   train --preset fruit_nerf --variant tpu (the frequency
                 field) for TPU_ITERS steps: finite losses, train PSNR
                 rising, no grid-kernel launch, a finite final eval
           tools (tools_phase, on the big and huge runs before their
                 directory goes): suggest-crop --grid TOOLS_GRID on big (more
                 than half the GT fruit centres inside the semantic AABB, K1
                 once a probe batch); export --mode pointcloud --data
                 <capture> of POINTCLOUD_CAMERAS cameras, subsampled to
                 POINTCLOUD_POINTS points (a non-empty finite
                 cloud, colours in [0, 1], K1 once a render chunk); the
                 viewer on big through serve(port=0) (/, /info, /render of
                 each panel full, preview and with a crop box, /suggest;
                 seconds a frame) and one huge parity frame (K3 once a chunk
                 in each field); dbscan_device and
                 radius_neighbor_mask_device on the card against the native
                 engine (same noise set, core labels and mask; seconds of
                 each) on big's fruit cloud and on 504,000 points on the GT
                 fruit shells; speed-probe --only SPEED_CANDIDATES (rays/s);
                 TRACE_STEPS grid steps under StepTimer and device_trace (a
                 Chrome trace that holds the cell kernels)
           then K1/K2 held and timed at the big run's last step's positions
           (16 levels of up to 16384 rows) and K3/K4 at the huge run's (the
           main field's fine samples at 16 x 2^21, each proposal field's
           8,388,608 samples at 7 x 2^18)
  scale-out
           K1/K2 at the fruit_nerf two-tier layout and K3/K4 at the parity
           main field (16 x 2^19, F = 2), SCENES scenes of P_SLICE points in
           one launch, and through the autograd Functions' vmap rules (as
           the multi-scene step launches them): each scene of both bitwise
           equal to its single launch and
           within the plain version's tolerances; medians of the batched
           launch, the SCENES single launches, the plain version, and one
           embedding_bag over the S·P·L rows, beside the bound (S single
           launches' bytes). Then ``multi-scene`` (GRID_CAMPAIGN, the JAX
           docstring's command at full width, CAMPAIGN_ITERS steps): losses
           finite and falling in every scene, a report row a scene, K1/K2
           launched as one scene's steps would launch them, each for all
           scenes, and each batched call of its last step held as above at
           its own operands (captured from the vmap rules' launches);
           SINGLE_SCENE_STEPS steps of its first scene alone, timed
           beside it; ``multi-scene --variant parity`` (PARITY_CAMPAIGN,
           CAMPAIGN_PARITY_ITERS steps) with K3/K4 likewise. Data parallel:
           2 gloo ranks spawned on the one card against 1 rank, the
           fruit_nerf grid preset at full width, DP_RAYS rays, DP_STEPS
           steps of train_loop from each of DP_SEEDS (the first step's losses
           within 2e-5; after it, parameters apart only where the one-rank
           gradient is rounding noise; every step's losses within
           DP_DRIFT_RTOL; the ranks bitwise equal; a planted fault, rank 1's
           gradient dropped, fails these checks), and one step on an NCCL
           group of one rank bitwise equal to the step without a mesh. --mesh: a MESH_ITERS
           run through ``train``; render and export on [card, card] against
           the unsharded results; eval, render, export and the viewer with
           --mesh (a one-card mesh) equal to the commands without it
Then one JSON line of the ten kernels (K1/K2's launches summed over the cell
slice, the orchard phase's, the disk phase's, the big run's and the tools'
counted calls, K3/K4's over the corner slice, the parity orchard, the smoke
run, the huge run and the tools; the K1-K4 entries also carry their
step-layout numbers, K1's its export-batch ones, K3/K4's the parity
layouts' at random points and at the parity step's and the huge step's
(huge_step), K1/K2's the big step's (big_step); then the four
scene-batched entries ``*_scenes``, whose launches are the campaigns'
steps', whose ``single_launches_ms`` is the SCENES single launches' and
whose ``campaign_step`` holds the campaigns' last-step calls; the kernel
phase's K2/K4 entries and the two ``*_bwd_scenes`` entries also carry the
backward's ``passes``: device ms a launch of the memset, the column
maxima, the adding kernel and the conversion, by torch.profiler; an
earlier ``kernels:`` line gives those launches' dTable runs and adds,
counted by ``hg.backward_adds``, their rate over the adding kernel's
measured time, and the counter's modeled L2 lines),
the card line,
and as the last line {"ok": true, "device": {...}}. It fails if jax or any
module of the JAX package (fruitnerf_tpu) was imported. Any failure raises
and exits non-zero; with no CUDA device it exits non-zero before printing
any result.

With --ab-cell-source it builds that other cell_encode.cu (for example the
parent commit's, from git show; it must have this checkout's C interface,
the scene axis included) apart, runs only
the card, build and cell slice phases, and times the other K1/K2 ("old")
against this checkout's ("new") and the plain version in turns (plain, old,
new, new, old, plain) at random points, at the last step's positions, at
an export batch and at a fruit_nerf_big step's positions (AB_STEPS steps of
step_bench's ``big`` on the slices' scene), each held to the plain version
first. --ab-corner-source does the same for another corner_encode.cu's
K3/K4 after the corner slice, at random points and the corner step's
positions, at the slice's F = 2 layout and at the kernel phase's F = 4
layout, and at the parity and huge (parity) steps' positions at their hash
layouts. Each also times the two backwards scene-batched (SCENES scenes of
P_SLICE random points at the scale-out phase's layouts). Either or both;
then one JSON line of those times, bounds and yardstick times, and the card
line.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
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
# The orchard phase runs the first ORCHARD_ITERS steps of the bench orchard's
# ORCHARD_SCHEDULE-step run (its learning rates; the default train seed) and
# must count there: at 2500 steps of that schedule every train seed of
# PERF.md's runs (42-46) counted, seed 42 last (IoU 0.55). A run of
# --iters 2500 alone decays its rates over 2500 steps, and seed 42 then
# stays in the all-background optimum (IoU 0.07, empty clouds). It was 700
# steps, with no count checked, before.
ORCHARD_ITERS = 2500
ORCHARD_SCHEDULE = 30000
COUNT_EXPORT_N = 384  # the grid orchard's export (bench.py's N): the cloud it counts
EXPORT_N = 256  # the parity orchard's export and the kernel phase's export batch
PARITY_ITERS = 200  # the parity variant's orchard steps (1000 until the scale-out phase,
# 700 until its campaign-call and seed checks, 500 until the orchard phase counted; its
# K3/K4 launches are also held by the hash phase and the parity campaign; two logged
# steps, every 100, for the rising-PSNR check)
LARGE_P = 2_000_000  # above this many points a kernel pair's medians are of 10 runs, not 30


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
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


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
    # millions of points take the plain versions a large part of a second a
    # call: there the medians are of fewer runs
    n = 30 if pos.shape[0] <= LARGE_P else 10
    times = {
        "fwd_ms": median_ms(lambda: fwd(table, pos), n),
        "fwd_plain_ms": median_ms(lambda: plain(table, pos), n),
        "bwd_ms": median_ms(lambda: bwd(table, pos, grad), n),
        "bwd_plain_ms": median_ms(
            lambda: torch.autograd.grad(plain_out, (t_, p_), grad, retain_graph=True), n),
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
        times["fwd_library_ms"] = median_ms(lib_fwd, n)
        times["bwd_library_ms"] = median_ms(lib_bwd, n)
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
    """``hold_pair``'s numbers of one direction ("fwd" or "bwd"), with the
    backward's ``passes`` where the hold asked for them: a call that
    ``passes_phase`` makes at the end of the run."""
    out = {"max_abs_err": r[f"{d}_err"], "ms": r[f"{d}_ms"], "plain_ms": r[f"{d}_plain_ms"],
           "bound_ms": r[f"{d}_bound_ms"], "bound_by": r[f"{d}_bound_by"],
           "library_ms": r[f"{d}_library_ms"]}
    if f"{d}_passes" in r:
        out["passes"] = r[f"{d}_passes"]
    return out


PASS_LAUNCHES = 5  # backward launches profiled for a pass split


def pass_split(bwd) -> dict:
    """Device ms a launch of each kernel and memset ``bwd()`` runs, by
    ``torch.profiler`` over PASS_LAUNCHES launches: each one's device time
    over the times it ran, so that a record the profiler drops leaves the
    mean as it was. A session that recorded no adding kernel is taken
    again, once."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(row):
        us = getattr(row, "self_device_time_total", None)
        return row.self_cuda_time_total if us is None else us

    for _ in range(2):
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PASS_LAUNCHES):
                bwd()
            torch.cuda.synchronize()
        total, count = {}, {}
        for row in prof.key_averages():
            if str(row.device_type).endswith("CUDA") and dev_us(row) > 0:
                name = re.sub(r"\(.*", "", row.key).replace("void ", "").strip()
                total[name] = total.get(name, 0.0) + dev_us(row)
                count[name] = count.get(name, 0) + row.count
        if any("_bwd_kernel" in name for name in total):
            break
    return {name: total[name] / 1e3 / count[name] for name in total}


def backward_passes(hg, label, bwd, pos, layout, features: int, corner: bool):
    """-> a call that splits a K2/K4 launch ``bwd()`` on positions ``pos``
    (one scene's, or [S, P, 3]) into its passes (``pass_split``) and prints
    beside them the launch's dTable runs and adds (``hg.backward_adds``,
    summed over the scenes), the adds a second over the adding kernel's
    measured time, and the counter's modeled L2 lines. ``passes_phase``
    makes the calls after every training phase, so that no timed phase
    runs in a process that torch.profiler has traced."""
    return lambda: _backward_passes(hg, label, bwd, pos, layout, features, corner)


def _backward_passes(hg, label, bwd, pos, layout, features: int, corner: bool) -> dict:
    split = pass_split(bwd)
    counts = collections.Counter()
    for p in (pos if pos.dim() == 3 else pos[None]):
        counts.update(hg.backward_adds(p, layout, features, corner))
    adding = [ms for name, ms in split.items() if "_bwd_kernel" in name]
    check(len(adding) <= 1, f"{label}: the backward's passes {sorted(split)}")
    rate = (f"{counts['adds'] / (adding[0] * 1e-3) / 1e9:.2f} G adds/s over the adding kernel"
            if adding else "the profiler recorded no adding kernel")
    print(f"kernels: {label} backward passes (ms a launch) "
          f"{ {k: round(v, 4) for k, v in split.items()} }; counted runs {counts['runs']}, "
          f"adds {counts['adds']} ({rate}); modeled L2 lines {counts['modeled_l2_lines']}")
    return split


def passes_phase(kernels: list[dict]) -> None:
    """Split the backwards of the kernels-JSON entries that asked for it
    (the kernel phase's K2/K4 and the ``*_bwd_scenes`` entries) into their
    passes, now that no training phase is left to run."""
    for k in kernels:
        if callable(k.get("passes")):
            k["passes"] = k["passes"]()


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


def cell_pair(hg, layout, label, table, pos, grad, passes: bool = False) -> dict:
    """K1/K2 at ``layout`` on these inputs, with the yardstick, bounds and,
    with ``passes``, the backward's passes."""
    def bwd(t, p, gr):
        return hg.cell_encode_bwd_cuda(t, p, gr, layout, True)

    r = hold_pair(
        label, lambda t, p: hg.cell_encode_fwd_cuda(t, p, layout), bwd,
        lambda t, p: hg.cell_encode_torch(t, p, layout),
        table, pos, grad,
        library=library_pair(hg, table, pos, grad, layout, corner=False),
        cost=work(hg, pos, layout, 2, corner=False),
    )
    if passes:
        r["bwd_passes"] = backward_passes(hg, label, lambda: bwd(table, pos, grad), pos,
                                          layout, 2, False)
    return r


def corner_pair(hg, layout, feats, label, table, pos, grad, passes: bool = False) -> dict:
    """K3/K4 at ``layout`` with ``feats`` features a level on these inputs,
    with the yardstick, bounds and, with ``passes``, the backward's
    passes."""
    def bwd(t, p, gr):
        return hg.corner_encode_bwd_cuda(t, p, gr, layout, feats, True)

    r = hold_pair(
        label, lambda t, p: hg.corner_encode_fwd_cuda(t, p, layout, feats), bwd,
        lambda t, p: hg.grid_encode_corner_torch(t, p, layout, feats),
        table, pos, grad,
        library=library_pair(hg, table, pos, grad, layout, corner=True),
        cost=work(hg, pos, layout, feats, corner=True),
    )
    if passes:
        r["bwd_passes"] = backward_passes(hg, label, lambda: bwd(table, pos, grad), pos,
                                          layout, feats, True)
    return r


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
        *_inputs(dev, g, cell_layout.total_rows, 16, 2 * cell_layout.num_levels), passes=True,
    )

    def corner(layout, feats, label, passes=False):
        inputs = _inputs(dev, g, layout.total_rows, feats, feats * layout.num_levels)
        return corner_pair(hg, layout, feats, label, *inputs, passes=passes)

    f = corner_grid.features_per_level
    layout = corner_grid.table_layout()
    k34 = corner(layout, f, f"K3/K4 corner ({layout.num_levels} levels, T={layout.rows[0]}, "
                            f"F={f}, direct {sum(layout.direct)})", passes=True)
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
    from fruitnerf_tpu_torch.engine.trainer import (
        compute_loss, draw_step, init_train_state, stage_scalars)

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
        stage_scalars(state, cfg)
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
def eager_steps():
    """Every train step in the block runs eagerly, a multi-scene one too
    (both ask ``step_graph.replay_key``): a step replayed from its CUDA
    graph runs no Python, so a spy on the kernels' calls sees only the steps
    that make them."""
    from fruitnerf_tpu_torch.engine import step_graph

    real = step_graph.replay_key
    step_graph.replay_key = lambda *args, **kwargs: None
    try:
        yield
    finally:
        step_graph.replay_key = real


@contextlib.contextmanager
def captured_positions(sink: list, entry: str = "cell_encode", when=lambda: True):
    """Record a copy of the positions that ``fields/encodings.grid_encode``
    hands to ``entry`` (``cell_encode``, or ``grid_encode_flat`` in corner
    mode) in the block, at each call made with gradients on while
    ``when()`` holds; the block's train steps run eagerly."""
    from fruitnerf_tpu_torch.fields import encodings

    real = getattr(encodings, entry)

    def spy(table, positions, *args):
        if torch.is_grad_enabled() and when():
            sink.append(positions.detach().clone())
        return real(table, positions, *args)

    setattr(encodings, entry, spy)
    try:
        with eager_steps():
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


def orchard_phase(dev, iters: int, export_n: int, hg, name: str, variant: str = "grid",
                  captured=None) -> dict:
    """The fruit-counting main path through its entry point,
    ``scripts.orchard_e2e.main --variant <variant>``, on the bench orchard
    at full width; then a second call on the same directory, which resumes
    at the final step. The grid variant's call first renders the scene into
    the cache both calls read; its learning rates decay over
    ORCHARD_SCHEDULE steps, and a semantic cloud must pass
    ``count_criterion``. ``captured`` (a sink, for the parity variant)
    receives the positions of every hash encoding made with gradients on.
    Returns the launches summed over the counted calls of both: K1/K2 on
    the grid variant, K3/K4 on the parity variant, each held to what the
    config predicts on the latter."""
    from fruitnerf_tpu_torch.data import synthetic
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.export import volume_sampler as vs
    from fruitnerf_tpu_torch.export.ply import read_ply
    from fruitnerf_tpu_torch.scripts import convergence, count, orchard_e2e

    tag = "orchard" if variant == "grid" else f"orchard {variant}"
    lib = count.native_library()
    check(lib is not None,
          "the native counting library did not build or load (g++ needed); large clouds "
          "would reach the JAX-only device DBSCAN")
    print(f"{tag}: native counting library {lib.name} loaded")

    cfg_scene = synthetic.orchard_config(**ORCHARD)
    if variant == "grid":
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
              f"{len(scene['poses'])} cameras at {cfg_scene.image_size}^2 ({pairs} ray-sphere "
              f"pairs a camera) rendered by the torch renderer and cached in {dt:.3f} s; camera "
              f"0's fruit mask differs from the numpy tracer's on {flips:.2e} of its pixels "
              f"(tol 2e-3)")
        check(flips <= 2e-3, f"the torch renderer's mask differs on {flips} of camera 0")

    parser = argparse.ArgumentParser()
    orchard_e2e.add_args(parser)
    spy = (contextlib.nullcontext() if captured is None
           else captured_positions(captured, "grid_encode_flat"))
    adjust = None
    if variant == "grid":  # the default train seed, the schedule of an ORCHARD_SCHEDULE-step run
        def adjust(c):
            return convergence.with_seed_and_schedule(c, c.seed, ORCHARD_SCHEDULE)
    with tempfile.TemporaryDirectory() as run_dir:
        args = parser.parse_args([
            "--num-fruits", str(ORCHARD["num_fruits"]), "--num-cameras", str(ORCHARD["num_cameras"]),
            "--image-size", str(ORCHARD["image_size"]), "--seed", str(ORCHARD["seed"]),
            "--iters", str(iters), "--sparsity-loss", "0.005", "--export-n", str(export_n),
            "--variant", variant, "--output-dir", run_dir,
        ])
        reports, counts = [], {}
        for call in range(2):
            with counted_calls(trainer, "train_loop", hg, counts), \
                    counted_calls(vs, "sample_volume", hg, counts), \
                    (spy if call == 0 else contextlib.nullcontext()):
                reports.append(orchard_e2e.main(args, adjust=adjust))
        first, second = reports
        log = [json.loads(x) for x in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
        clouds = {k: read_ply(Path(run_dir) / f"{k}.ply")["points"]
                  for k in ("semantic", "semantic_colormap")}
    batches = math.ceil(export_n**2 / vs.rays_per_batch(vs.ExportConfig(num_points_per_side=export_n)))

    steps = first["steps_run"]
    rays = first["train_rays_per_sec_train_only"]
    check(first["device"] == second["device"] == name,
          f"the reports name {first['device']!r} and {second['device']!r}, not {name!r}")
    print(f"{tag}: reports taken on {first['device']}; scene {first['render_scene_s']:.3f} s "
          f"in orchard_e2e.main (its cache); "
          f"train {steps} steps: {rays / 4096:.3f} steps/s = {rays:.1f} rays/s over train_s "
          f"{first['loop_timings']['train_s']:.3f} s (overall {first['train_rays_per_sec']:.1f} "
          f"rays/s over {first['train_s']:.3f} s with evals and saves) on {name}")
    check(steps == iters, f"ran {steps} steps of {iters}")
    train = [r for r in log if "total_loss" in r]
    print(f"{tag}: train PSNR " + ", ".join(f"{r['psnr']:.3f} dB at {r['step']}" for r in train))
    check(all(math.isfinite(r[k]) for r in train for k in LOSS_KEYS), "a loss is not finite")
    check(train[-1]["psnr"] > train[0]["psnr"], f"{tag}: train PSNR did not rise")
    ev = first["eval"]
    print(f"{tag}: eval over the held-out cameras: PSNR {ev['psnr']:.3f} dB, SSIM "
          f"{ev['ssim']:.4f}, IoU {ev['iou']:.4f}, {ev['num_rays_per_sec']:.1f} rays/s "
          f"({first['eval_s']:.3f} s)")
    check(all(math.isfinite(v) for v in ev.values()), f"eval stats not finite: {ev}")
    check(-1.0 <= ev["ssim"] <= 1.0, f"SSIM out of [-1, 1]: {ev['ssim']}")
    train_counts, export_counts = counts["train_loop"][0], counts["sample_volume"][0]
    print(f"{tag}: launches in train_loop ({steps} steps, evals every 500): {train_counts}")
    if variant == "grid":
        fwd, bwd = "cell_encode_fwd", "cell_encode_bwd"
        check(train_counts[fwd] >= 2 * steps, "a train step skipped K1")
        check(train_counts[bwd] >= steps, "a train step skipped K2")
    else:
        fwd, bwd = "corner_encode_fwd", "corner_encode_bwd"
        cfg = parity_config(ORCHARD["num_cameras"], iters)
        chunks = math.ceil(ORCHARD["image_size"] ** 2 / cfg.eval_rays_per_chunk)
        want = predicted_hash_launches(cfg, range(iters), iters // cfg.steps_per_eval, chunks)
        print(f"{tag}: predicted launches in train_loop {want}")
        check(train_counts == want, "the parity run's launches differ from the prediction")
    pts = first["export_points"]
    print(f"{tag}: export N={export_n} ({export_n**3} probes, {batches} batches) in "
          f"{first['export_s']:.3f} s = {first['export_probes_per_sec']:.1f} probes/s; points "
          f"{pts}; launches {export_counts}")
    check(export_counts[fwd] == batches,
          f"export launched {fwd} {export_counts[fwd]} times for {batches} batches")
    check(sum(export_counts.values()) == batches, f"export launched another kernel: {export_counts}")
    check(pts["density"] > 0, "the density cloud is empty")
    for cloud, c in first["counting"].items():
        if "error" in c:
            print(f"{tag}: count on {cloud}: {c['error']}")
            check(pts[cloud] == 0, f"{cloud} has points but no count")
        else:
            print(f"{tag}: count on {cloud}: {c['count']}/{first['gt_count']} "
                  f"({c['count_error_pct']:.2f}% error), F1 {c['F1']:.4f}, precision "
                  f"{c['precision']:.4f}, recall {c['recall']:.4f}")
            check(c["count"] >= 0 and 0.0 <= c["F1"] <= 1.0, f"count on {cloud}: {c}")
    print(f"{tag}: count_s {first['count_s']:.3f} s")
    if variant == "grid":  # the main path must count
        gt = synthetic.fruit_centers(cfg_scene)
        passed = []
        for cloud, points in clouds.items():
            near, fails = count_criterion(points, first["counting"][cloud]["count"], gt,
                                          cfg_scene.fruit_radius)
            print(f"{tag}: {cloud} cloud: {len(points)} points, {near:.4f} within 2 fruit radii "
                  f"of a GT centre, count {first['counting'][cloud]['count']} of {len(gt)}: "
                  + ("; ".join(fails) if fails else "counts"))
            passed += [cloud] if not fails else []
        check(bool(passed), f"{tag}: no semantic cloud counts after {steps} steps")

    print(f"{tag}: second call resumed at step {second.get('resumed_from_step')}, ran "
          f"{second['steps_run']} steps; train_rays_per_sec {second['train_rays_per_sec']}; "
          f"export points {second['export_points']}")
    check(second.get("resumed_from_step") == iters and second["steps_run"] == 0,
          "the second call did not resume at the final step")
    check(second["train_rays_per_sec"] is None and second["train_rays_per_sec_train_only"] is None,
          "a zero-step run reported a rate")
    check(second["export_points"] == pts, "the resumed run exported other clouds")
    check(counts["train_loop"][1][fwd] == counts["train_loop"][1][bwd] == 0,
          "the zero-step resume launched a kernel in train_loop")
    check(counts["sample_volume"][1][fwd] == batches, "the second export's launch count")
    runs = counts["train_loop"] + counts["sample_volume"]
    return {k: sum(c[k] for c in runs) for k in runs[0]}


# ---------------------------------------------------------------------------
# the hash-grid slice: the parity variant and the smoke preset
# ---------------------------------------------------------------------------


def parity_config(num_images: int, iters: int):
    """The ``fruit_nerf`` preset's parity variant as orchard_e2e builds it
    (sparsity 0.005, ``iters`` steps)."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf

    cfg = apply_overrides(fruit_nerf(num_images, variant="parity"), {"sparsity_loss": 0.005})
    return dataclasses.replace(cfg, max_iters=iters)


def hash_layouts(cfg) -> list:
    """(name, HashEncodingConfig, points a train step gives it) of each hash
    encoding of a model: the main field (its fine samples), then each
    proposal field (its proposal samples)."""
    m, rays = cfg.model, cfg.train_rays_per_batch
    out = [("main", m.field.hash, rays * m.num_nerf_samples)]
    for i, (net, s) in enumerate(zip(m.proposal_nets, m.num_proposal_samples)):
        out.append((f"proposal{i}", net.hash, rays * s))
    return out


def _hash_label(name, enc, p) -> str:
    res = enc.level_resolutions()
    return (f"K3/K4 {name} ({enc.num_levels} levels, T=2^{enc.log2_hashmap_size}, "
            f"F={enc.features_per_level}, res {res[0]}..{res[-1]}, "
            f"direct {sum(enc.table_layout().direct)}) at P={p}")


def hash_kernel_phase(hg, cfg, dev, seed: int) -> dict:
    """K3/K4 at each hash layout of the parity variant, at uniform-random
    points: the main field's at P_SLICE (a step's fine samples and sparsity
    points), each proposal field's at the points a step gives it."""
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {}
    for name, enc, p in hash_layouts(cfg):
        p = P_SLICE if name == "main" else p
        f, layout = enc.features_per_level, enc.table_layout()
        inputs = _inputs(dev, g, layout.total_rows, f, enc.out_dim, p=p)
        out[name] = {"points": p, **corner_pair(hg, layout, f, _hash_label(name, enc, p), *inputs)}
    return out


def hash_step_layouts(hg, cfg, captured: list, dev, seed: int) -> dict:
    """K3/K4 at the positions of a hash-grid step's encodings (captured in
    the order the step makes them: proposal 0, proposal 1, the main field's
    fine samples, and its sparsity points where the config has the prior),
    each at its own layout."""
    layouts = hash_layouts(cfg)
    encs = {name: enc for name, enc, _ in layouts}
    names = ["proposal0", "proposal1", "main"]
    want = [(p, 3) for _, _, p in layouts[1:]] + [(layouts[0][2], 3)]
    if cfg.model.density_sparsity_mult > 0:
        names.append("sparsity")
        want.append((cfg.model.sparsity_num_points, 3))
    check([tuple(c.shape) for c in captured] == want,
          f"the last hash-grid step encoded {[tuple(c.shape) for c in captured]} points")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    out = {}
    for name, pos in zip(names, captured):
        enc = encs["main" if name == "sparsity" else name]
        f, layout = enc.features_per_level, enc.table_layout()
        inputs = _inputs(dev, g, layout.total_rows, f, enc.out_dim, pos=pos.contiguous())
        label = _hash_label(name, enc, pos.shape[0]).replace(" at P", " at the step's points, P")
        out[name] = {"points": pos.shape[0], **corner_pair(hg, layout, f, label, *inputs)}
    return out


def predicted_hash_launches(cfg, steps: range, evals: int, chunks: int) -> dict:
    """K3/K4 launches of ``train_loop`` over ``steps`` on a model whose
    encodings are all corner-mode hash grids: each step encodes forward its
    fine samples (and its sparsity points) in the main field and its
    proposal samples in each proposal field; backward, the main field's
    encodings every step and each proposal field's on the steps the
    proposals train (``proposal_updated``); an eval chunk encodes forward in
    every field."""
    from fruitnerf_tpu_torch.models.fruit_model import proposal_updated

    m = cfg.model
    main = 1 + int(m.density_sparsity_mult > 0)
    nets = len(m.proposal_nets)
    trained = sum(proposal_updated(s, m) for s in steps)
    return {"cell_encode_fwd": 0, "cell_encode_bwd": 0,
            "corner_encode_fwd": len(steps) * (main + nets) + evals * chunks * (1 + nets),
            "corner_encode_bwd": len(steps) * main + trained * nets}


def repeat_check(label: str, cfg, data, seed: int) -> dict:
    """Two runs of REPEAT_STEPS steps from one seed on the same draws, on
    the kernels: every loss and parameter must be bitwise equal."""
    from fruitnerf_tpu_torch.scripts.step_bench import REPEAT_STEPS, two_runs

    r = two_runs(cfg, data, seed, REPEAT_STEPS)
    print(f"{label}: two runs of {REPEAT_STEPS} steps from seed {seed} on the same draws: "
          f"bitwise {r['bitwise']}; losses max rel diff {r['loss_max_rel']:.3e}; "
          f"{r['leaves_differ']} of {r['leaves']} parameters differ, by at most "
          f"{r['param_max_abs']:.3e}")
    check(r["bitwise"], f"{label}: two runs from one seed differ")
    return r


SMOKE_ITERS = 200


def smoke_phase(dev, hg, name: str, seed: int) -> dict:
    """The smoke preset through its entry point, ``scripts.train.main``
    (``--preset fruit_nerf_smoke --data synthetic``), SMOKE_ITERS steps: the
    log's losses finite and its train PSNR rising, a final eval, K3/K4
    launches as the config predicts. Then the repeat check on the smoke
    preset. Returns the launches of its train_loop."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.scripts import train as train_cli

    parser = argparse.ArgumentParser()
    train_cli.add_args(parser)
    counts: dict = {}
    with tempfile.TemporaryDirectory() as run_dir:
        args = parser.parse_args(["--preset", "fruit_nerf_smoke", "--data", "synthetic",
                                  "--max-iters", str(SMOKE_ITERS), "--output-dir", run_dir])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted_calls(trainer, "train_loop", hg, counts):
            state, _ = train_cli.main(args)
        wall = time.perf_counter() - t0
        records = [json.loads(x) for x in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
        manifest = json.loads((Path(run_dir) / "manifest.json").read_text())
    train = [r for r in records if "total_loss" in r]
    final = [r for r in records if "final_eval_psnr" in r]
    print(f"smoke: scripts.train.main --preset fruit_nerf_smoke --data synthetic --max-iters "
          f"{SMOKE_ITERS} in {wall:.3f} s on {name}; step {state.step}; train PSNR "
          + ", ".join(f"{r['psnr']:.3f} dB at {r['step']}" for r in train)
          + f"; final eval PSNR {final[0]['final_eval_psnr']:.3f} dB; manifest hash entry "
          f"{manifest['hash']['table_shape']}")
    check(state.step == SMOKE_ITERS, f"the smoke run stopped at step {state.step}")
    check(len(train) >= 2 and all(math.isfinite(r[k]) for r in train for k in LOSS_KEYS[:4]),
          "a smoke loss is not finite")
    check(train[-1]["psnr"] > train[0]["psnr"], "the smoke run's train PSNR did not rise")
    check(len(final) == 1 and math.isfinite(final[0]["final_eval_psnr"]), "no final smoke eval")
    cfg = fruit_nerf_smoke(24)
    scene_px = 128 * 128
    want = predicted_hash_launches(cfg, range(SMOKE_ITERS), SMOKE_ITERS // cfg.steps_per_eval,
                                   math.ceil(scene_px / cfg.eval_rays_per_chunk))
    got = counts["train_loop"][0]
    print(f"smoke: launches in train_loop {got}, predicted {want}")
    check(got == want, "the smoke run's K3/K4 launches differ from the prediction")

    scene = render_scene(SyntheticSceneConfig(num_cameras=24, image_size=128, seed=seed), device=dev)
    repeat_check("smoke", cfg, dataset_from_scene(scene, dev), seed)
    return got


# ---------------------------------------------------------------------------
# the disk capture workflow: train --data <dir>, eval, render, export, count
# ---------------------------------------------------------------------------

DISK_ITERS = 2000  # the disk phase's steps
APPLIED_SCALE = 0.5  # the capture's applied_scale: export lengths come out x 1/0.5
DISK_EXPORT_N = 256
# The crop box, in the export's probe frame (half the training frame): the
# dataparser centres the orchard's cameras and scales them into the unit
# box, which puts the canopy at |x|, |y| <= 0.11, z in [-0.36, -0.15].
DISK_BOX = ((-0.16, -0.16, -0.42), (0.16, 0.16, -0.09))
# Export thresholds (semantic logit, density, colormap sigmoid), picked from
# a probe and a sweep of exports of a field trained DISK_ITERS steps (PERF.md
# section 6): the reference's own, which gave the best count there.
DISK_THRESHOLDS = (3.0, 70.0, 0.9)
CAPTURE_FRAMES = 8  # frames at the dataparser's 1200 x 900 cap, for the load time


def predicted_cell_launches(cfg, steps: int, eval_chunks: int) -> dict:
    """K1/K2 launches of the grid variant (frequency proposal fields): each
    train step encodes its fine samples and its sparsity points forward and
    backward; each eval chunk encodes forward once."""
    main = 1 + int(cfg.model.density_sparsity_mult > 0)
    return {"cell_encode_fwd": steps * main + eval_chunks, "cell_encode_bwd": steps * main,
            "corner_encode_fwd": 0, "corner_encode_bwd": 0}


def lpips_npz(path: Path, seed: int) -> Path:
    """A tiny 2-stage LPIPS weights file in utils/lpips.py's schema (no
    pretrained weights exist here): stage 0 two convs 3->4->4, stage 1 one
    conv 4->6, non-negative lin heads."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    np.savez(path, shift=np.array([-0.030, -0.088, -0.188], np.float32),
             scale=np.array([0.458, 0.448, 0.450], np.float32),
             stage0_conv0_w=r(4, 3, 3, 3), stage0_conv0_b=r(4, s=0.1),
             stage0_conv1_w=r(4, 4, 3, 3), stage0_conv1_b=r(4, s=0.1),
             stage1_conv0_w=r(6, 4, 3, 3), stage1_conv0_b=r(6, s=0.1),
             lin0_w=np.abs(r(1, 4, 1, 1, s=1.0)), lin1_w=np.abs(r(1, 6, 1, 1, s=1.0)))
    return path


def half_resolution(tree: Path, scene: dict) -> tuple[np.ndarray, np.ndarray]:
    """Write ``images_2/`` and ``masks_2/`` (the folders the dataparser maps
    the fixture's ``images/`` and ``masks/`` to at downscale 2) from a 2x2
    box average of the capture's frames; returns the uint8 stacks written."""
    from PIL import Image

    imgs = (np.clip(scene["images"], 0, 1) * 255).astype(np.uint8)
    n, h, w, _ = imgs.shape
    half = np.round(imgs.reshape(n, h // 2, 2, w // 2, 2, 3).astype(np.float32).mean((2, 4)))
    half = half.astype(np.uint8)
    masks = ((scene["masks"] > 0.5).reshape(n, h // 2, 2, w // 2, 2).mean((2, 4)) >= 0.5)
    masks = (masks * 255).astype(np.uint8)
    for d in ("images_2", "masks_2"):
        (tree / d).mkdir()
    for i in range(n):
        Image.fromarray(half[i]).save(tree / "images_2" / f"frame_{i:05d}.png")
        Image.fromarray(masks[i]).save(tree / "masks_2" / f"frame_{i:05d}.png")
    return half, masks


def capture_size_load(scene: dict, root: Path, dev) -> float:
    """Seconds for ``dataset_from_parsed`` to load CAPTURE_FRAMES frames of
    1200 x 900, the dataparser's automatic cap: orchard frames upsampled
    (bilinear, so as smooth as a photograph) and saved with Pillow's default
    adaptive row filters, as a capture's PNGs are."""
    from PIL import Image

    from fruitnerf_tpu_torch.data.builder import dataset_from_parsed
    from fruitnerf_tpu_torch.data.dataparser import DataParserConfig, parse_transforms
    from fruitnerf_tpu_torch.data.fixture import write_scene_capture

    k = CAPTURE_FRAMES
    frames = [np.asarray(Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8))
                         .resize((1200, 900), Image.BILINEAR)) for im in scene["images"][:k]]
    masks = [np.asarray(Image.fromarray((m > 0.5).astype(np.uint8) * 255)
                        .resize((1200, 900), Image.NEAREST)) for m in scene["masks"][:k]]
    s = 1200 / scene["width"]
    big = dict(images=np.stack(frames).astype(np.float32) / 255.0,
               masks=np.stack(masks).astype(np.float32) / 255.0, poses=scene["poses"][:k],
               fx=scene["fx"] * s, fy=scene["fy"] * s, cx=600.0, cy=450.0, width=1200,
               height=900)
    write_scene_capture(big, root)
    parsed = parse_transforms(DataParserConfig(data_dir=root))
    check(set(parsed.width.tolist()) == {1200}, "the capture-size frames were downscaled")
    t0 = time.perf_counter()
    data = dataset_from_parsed(parsed, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(np.array_equal(data.images.cpu().numpy(), np.stack(frames)),
          "the capture-size frames load wrongly")
    return load_s


def probe_field(state, cfg, box_points: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Density and semantic logit of the trained field at points of the
    export's probe frame (the AABB normalization export uses)."""
    from fruitnerf_tpu_torch.fields.fruit_field import fruit_field_forward

    dev = box_points.device
    k = box_points.shape[0]
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev)
    with torch.inference_mode():
        out = fruit_field_forward(
            state.params["model"]["field"], box_points[:, None, :],
            torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(k, 3),
            torch.zeros(k, dtype=torch.int64, device=dev), cfg.model.field, train=False,
            contraction=False, aabb=aabb)
    return (out["density"][:, 0].float().cpu().numpy(),
            out["semantics"][:, 0, 0].float().cpu().numpy())


def _pcts(x: np.ndarray) -> str:
    return "/".join(f"{v:.3g}" for v in np.percentile(x, (10, 50, 90)))


def gt_in_capture(manifest: dict, scene: dict) -> tuple[np.ndarray, float]:
    """GT fruit centres and radius in a capture run's training frame."""
    tr = np.asarray(manifest["dataparser_transform"], np.float64)
    gt = np.asarray(scene["fruit_centers"], np.float64) @ tr[:, :3].T + tr[:, 3]
    return gt, float(scene["fruit_radius"])


def probe_capture(tag: str, run_dir: Path, manifest: dict, scene: dict, cfg, dev, rng):
    """Density and semantic logit of a capture run's field at the fruit
    centres, on their shells (0.8 r) and at background points of DISK_BOX:
    what DISK_THRESHOLDS are picked from."""
    from fruitnerf_tpu_torch.engine.runs import load_run

    s_box = manifest["dataparser_scale"] / APPLIED_SCALE / 2.0  # world -> probe frame
    gt, r_world = gt_in_capture(manifest, scene)
    dirs = rng.standard_normal((len(gt), 8, 3))
    shell = gt[:, None] + 0.8 * r_world * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    lo, hi = np.asarray(DISK_BOX[0]), np.asarray(DISK_BOX[1])
    bg = lo + (hi - lo) * rng.random((20000, 3))
    far = np.linalg.norm(bg[:, None] - gt[None] * s_box, axis=-1).min(1) > 3 * r_world * s_box
    _, _, state = load_run(run_dir, dev)
    for label, pts in (("centres", gt * s_box), ("shells", shell.reshape(-1, 3) * s_box),
                       ("background", bg[far])):
        dens, logit = probe_field(state, cfg, torch.tensor(pts, dtype=torch.float32, device=dev))
        print(f"{tag}: probe at {len(pts)} {label}: density p10/50/90 {_pcts(dens)}, "
              f"semantic logit p10/50/90 {_pcts(logit)}")


def export_and_count(tag: str, run_dir: Path, manifest: dict, scene: dict, exp_dir: Path, hg,
                     counts: dict, fwd: str, count: bool = True) -> dict:
    """``export`` of a capture run in DISK_BOX at DISK_THRESHOLDS (its
    launches: one ``fwd`` a batch), then ``count`` of the fruit cloud: more
    than half of it within two fruit radii of a GT centre, a count in
    [1, 3 x GT]. ``count=False`` exports alone, with no check on the cloud."""
    from fruitnerf_tpu_torch.export import volume_sampler as vs
    from fruitnerf_tpu_torch.scripts import count as count_cli
    from fruitnerf_tpu_torch.scripts import export as export_cli

    batches = math.ceil(DISK_EXPORT_N**2 / vs.rays_per_batch(
        vs.ExportConfig(num_points_per_side=DISK_EXPORT_N)))
    with counted_calls(vs, "sample_volume", hg, counts):
        t0 = time.perf_counter()
        clouds = run_cli(export_cli, [
            "--load-dir", run_dir, "--output-dir", exp_dir,
            "--num-points-per-side", DISK_EXPORT_N,
            "--bounding-box-min", *DISK_BOX[0], "--bounding-box-max", *DISK_BOX[1],
            "--semantic-logit-threshold", DISK_THRESHOLDS[0],
            "--density-threshold", DISK_THRESHOLDS[1],
            "--colormap-prob-threshold", DISK_THRESHOLDS[2]])
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
    got = counts["sample_volume"][-1]
    check(got[fwd] == batches and sum(got.values()) == batches,
          f"{tag}: export launched {got} for {batches} batches")
    summary = (f"{tag}: export N={DISK_EXPORT_N} in the crop box {DISK_BOX} at thresholds "
               f"{DISK_THRESHOLDS}: {export_s:.3f} s ({batches} batches, {fwd} {got[fwd]}); "
               "points " + ", ".join(f"{k} {len(v['points'])}" for k, v in clouds.items()))
    out = {"export_s": export_s, "points": {k: len(v["points"]) for k, v in clouds.items()}}
    if not count:
        print(summary)
        return out
    # exported points land at dataparser_transform @ world / applied_scale
    gt, r_world = gt_in_capture(manifest, scene)
    r_out, gt_count = r_world / APPLIED_SCALE, len(gt)
    pts = clouds["semantic_colormap"]["points"]
    check(len(pts) > 0, f"{tag}: the fruit cloud is empty")
    t0 = time.perf_counter()
    results = run_cli(count_cli, [
        "--cloud", exp_dir / "semantic_colormap.ply", "--eps", 0.6 * r_out,
        "--min-samples", 4, "--remove-outliers-nb-points", 3,
        "--remove-outliers-radius", 0.45 * r_out, "--down-sample", 0.05 * r_out,
        "--cluster-merge-distance", 1.2 * r_out, "--template-size", r_out / 0.04,
        "--gt-count", gt_count, "--output", exp_dir / "count.json"])
    count_s = time.perf_counter() - t0
    (row,) = results.values()
    row.setdefault("count", row.get("error"))
    near, fails = count_criterion(pts, row["count"], gt / APPLIED_SCALE, r_out)
    print(f"{summary}; {near:.4f} of the fruit cloud within 2 fruit radii of a GT centre; "
          f"count {row['count']}/{gt_count} in {count_s:.3f} s (cloud "
          f"{Path(row['cloud_used']).name})")
    check(not fails, f"{tag}: " + "; ".join(fails))
    return {**out, "near": near, "count": row["count"], "count_s": count_s}


def count_criterion(points, count: int, gt_centers, radius: float) -> tuple[float, list[str]]:
    """The check that a fruit cloud counts: it is non-empty, more than half
    of its points lie within 2 fruit radii of a GT centre, and its count
    lies in [1, 3 x GT]. Returns (that share, the criteria it fails)."""
    from fruitnerf_tpu_torch.scripts.convergence import near_share

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_centers, np.float64).reshape(-1, 3)
    if len(pts) == 0:
        return 0.0, ["the cloud is empty"]
    near = near_share(pts, gt, radius)
    fails = []
    if not near > 0.5:
        fails.append(f"only {near:.2%} of the cloud lies within 2 fruit radii of a GT centre")
    if not 1 <= count <= 3 * len(gt):
        fails.append(f"count {count} of {len(gt)} is outside [1, 3 x GT]")
    return near, fails


def run_cli(module, argv):
    """An entry point's ``main`` on its own argument parser."""
    parser = argparse.ArgumentParser()
    module.add_args(parser)
    return module.main(parser.parse_args([str(a) for a in argv]))


def summed(counts: dict) -> dict:
    """Launches summed over every counted call in ``counts``."""
    runs = [c for v in counts.values() for c in v]
    return {k: sum(c[k] for c in runs) for k in runs[0]}


def disk_phase(dev, hg, name: str, seed: int) -> dict:
    """The disk capture workflow through its entry points, on the bench
    orchard written as a capture tree (``transforms.json``, PNG images and
    masks through Pillow, explicit val split, applied_scale
    APPLIED_SCALE, a 2x pyramid): ``train --data <tree>`` at full width,
    ``eval`` with a tiny LPIPS npz, ``render``, ``export`` with a crop box,
    ``count``. Returns the K1/K2 launches of its counted calls."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf
    from fruitnerf_tpu_torch.data import synthetic
    from fruitnerf_tpu_torch.data.builder import dataset_from_parsed
    from fruitnerf_tpu_torch.data.dataparser import DataParserConfig, parse_transforms
    from fruitnerf_tpu_torch.data.fixture import write_scene_capture
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.scripts import evaluate as eval_cli
    from fruitnerf_tpu_torch.scripts import render as render_cli
    from fruitnerf_tpu_torch.scripts import train as train_cli

    import PIL
    from PIL import Image
    print(f"disk: Pillow {PIL.__version__} reads and writes the capture's images")

    cfg_scene = synthetic.orchard_config(**ORCHARD)
    check(synthetic.scene_cache_path(cfg_scene).exists(), "the orchard scene is not cached")
    scene = synthetic.cached_render_scene(cfg_scene, device=dev)  # the orchard phase's cache
    n_cams, size = len(scene["poses"]), cfg_scene.image_size
    counts: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree, run_dir = tmp / "capture", tmp / "run"
        t0 = time.perf_counter()
        write_scene_capture(scene, tree, eval_fraction=0.1, applied_scale=APPLIED_SCALE)
        half, half_masks = half_resolution(tree, scene)
        write_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        parsed = parse_transforms(DataParserConfig(data_dir=tree))
        parse_s = time.perf_counter() - t0
        data = dataset_from_parsed(parsed, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0 - parse_s
        check(tuple(data.images.shape) == (n_cams, size, size, 3), f"images {data.images.shape}")
        frames = (np.clip(scene["images"], 0, 1) * 255).astype(np.uint8)
        check(np.array_equal(data.images.cpu().numpy(), frames), "the loaded frames differ")
        check(len(parsed.eval_indices) == round(0.1 * n_cams), "the explicit val split")
        h_parsed = parse_transforms(DataParserConfig(data_dir=tree, downscale_factor=2))
        h_data = dataset_from_parsed(h_parsed, dev)
        check(np.array_equal(h_data.images.cpu().numpy(), half)
              and np.array_equal(h_data.masks.cpu().numpy() * 255, half_masks)
              and set(h_parsed.width.tolist()) == {size // 2}
              and np.allclose(h_parsed.fx * 2, parsed.fx), "the images_2/ pyramid level")
        del data, h_data
        rng = np.random.default_rng(seed)
        big_s = capture_size_load(scene, tmp / "capture_1200", dev)
        print(f"disk: wrote the capture ({n_cams} frames at {size}^2 and its images_2/ level, "
              f"PNG) in {write_s:.3f} s; host: parse_transforms {parse_s:.4f} s, "
              f"dataset_from_parsed of {n_cams} frames onto the card {load_s:.3f} s; "
              f"dataset_from_parsed of {CAPTURE_FRAMES} frames at 1200x900 (Pillow's adaptive "
              f"filters) {big_s:.3f} s = {big_s / CAPTURE_FRAMES * 1e3:.1f} ms a frame; the "
              f"downscale-2 level parses to {size // 2}^2 and loads as written")

        with counted_calls(trainer, "train_loop", hg, counts), \
                counted_calls(trainer, "evaluate_all", hg, counts):
            t0 = time.perf_counter()
            state, timings = run_cli(train_cli, ["--data", tree, "--output-dir", run_dir,
                                             "--max-iters", DISK_ITERS, "--sparsity-loss", 0.005,
                                             "--seed", seed])
            train_wall = time.perf_counter() - t0
        manifest = json.loads((run_dir / "manifest.json").read_text())
        log = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
        fresh = parse_transforms(DataParserConfig(data_dir=tree))
        check(np.array_equal(np.asarray(manifest["dataparser_transform"], np.float32),
                             fresh.dataparser_transform)
              and manifest["dataparser_scale"] == fresh.dataparser_scale
              and manifest["downscale_factor"] is None,
              "the manifest's transform or scale differs from a fresh parse")
        train = [r for r in log if "total_loss" in r]
        final = [r for r in log if "final_eval_psnr" in r]
        check(state.step == DISK_ITERS and train[-1]["psnr"] > train[0]["psnr"]
              and all(math.isfinite(r[k]) for r in train for k in LOSS_KEYS),
              "the disk run did not train")
        cfg = apply_overrides(fruit_nerf(n_cams), {"sparsity_loss": 0.005})
        chunks = math.ceil(size * size / cfg.eval_rays_per_chunk)
        want = predicted_cell_launches(cfg, DISK_ITERS,
                                       DISK_ITERS // cfg.steps_per_eval * chunks)
        got = counts["train_loop"][0]
        rays = DISK_ITERS * cfg.train_rays_per_batch / timings["train_s"]
        print(f"disk: train --data <capture> --max-iters {DISK_ITERS} --sparsity-loss 0.005 in "
              f"{train_wall:.3f} s on {name}: train_s {timings['train_s']:.3f} s = {rays:.1f} "
              f"rays/s ({rays / cfg.train_rays_per_batch:.3f} steps/s), eval_s "
              f"{timings['eval_s']:.3f}, save_s {timings['save_s']:.3f}; train PSNR "
              + ", ".join(f"{r['psnr']:.3f} dB at {r['step']}" for r in train[::4])
              + f"; final eval over {len(parsed.eval_indices)} val cameras PSNR "
              f"{final[0]['final_eval_psnr']:.3f} dB; manifest scale "
              f"{manifest['dataparser_scale']:.6f} equals a fresh parse")
        print(f"disk: launches in train_loop {got}, predicted {want}")
        check(got == want, "the disk run's K1/K2 launches differ from the prediction")
        check(counts["evaluate_all"][0]["cell_encode_fwd"] == len(parsed.eval_indices) * chunks,
              "the final eval's K1 launches")

        lp = lpips_npz(tmp / "lpips_tiny.npz", seed)
        with counted_calls(trainer, "evaluate_all", hg, counts):
            ev = run_cli(eval_cli, ["--load-dir", run_dir, "--data", tree, "--lpips-weights", lp])
        print(f"disk: eval over the val split ({ev['num_images_evaluated']} cameras) on "
              f"{ev['device']}: PSNR {ev['psnr']:.3f} dB, SSIM {ev['ssim']:.4f}, IoU "
              f"{ev['iou']:.4f}, LPIPS (tiny random weights) {ev['lpips']:.5f}, "
              f"{ev['num_rays_per_sec']:.1f} rays/s")
        check(torch.device(ev["device"]).type == dev.type
              and ev["num_images_evaluated"] == len(parsed.eval_indices),
              f"eval ran on {ev['device']} over {ev['num_images_evaluated']} cameras")
        check(all(math.isfinite(ev[k]) for k in ("psnr", "ssim", "iou"))
              and 0.0 <= ev["lpips"] < math.inf, f"eval stats: {ev}")
        check(counts["evaluate_all"][1]["cell_encode_fwd"] == len(parsed.eval_indices) * chunks,
              "eval's K1 launches")

        cam = int(parsed.eval_indices[0])
        with counted_calls(trainer, "render_camera", hg, counts):
            panels = run_cli(render_cli, ["--load-dir", run_dir, "--data", tree,
                                          "--output-dir", tmp / "render", "--cameras", cam])
        shapes = [(Image.open(p).mode, Image.open(p).size) for p in panels]
        print(f"disk: render camera {cam}: {[p.name for p in panels]}, each {shapes[0]}")
        check(len(panels) == 5 and all(s == ("RGB", (size, size)) for s in shapes),
              f"panels {shapes}")
        check(counts["render_camera"][0]["cell_encode_fwd"] == chunks, "render's K1 launches")

        # the probe behind DISK_THRESHOLDS, then the export and count there
        probe_capture("disk", run_dir, manifest, scene, cfg, dev, rng)
        export_and_count("disk", run_dir, manifest, scene, tmp / "export", hg, counts,
                         "cell_encode_fwd")
    return summed(counts)


# ---------------------------------------------------------------------------
# the big, huge and tpu configurations, from a raw capture through process-data
# ---------------------------------------------------------------------------

PRESET_CAMERAS = 240  # at the presets' 0.99 split, more than max_train_images (200) train
BIG_ITERS = 1000
HUGE_ITERS = 200  # 300 until the orchard phase counted; two logged steps at least
TPU_ITERS = 250  # 500 until the orchard phase counted


def write_processed_capture(dev, root: Path) -> tuple[dict, Path, float]:
    """The bench orchard at PRESET_CAMERAS cameras written as a raw capture
    (``write_scene_capture``, no explicit split, applied_scale
    APPLIED_SCALE), then ``process-data --num-downscales 1``: the processed
    tree's transforms.json must equal a fresh merge of the raw one, and its
    ``images_2/`` and ``semantics_2/`` hold every frame at half size. ->
    (scene, processed tree, process-data seconds)."""
    from PIL import Image

    from fruitnerf_tpu_torch.data import synthetic
    from fruitnerf_tpu_torch.data.fixture import write_scene_capture
    from fruitnerf_tpu_torch.scripts import process_data

    cfg_scene = synthetic.orchard_config(**{**ORCHARD, "num_cameras": PRESET_CAMERAS})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = synthetic.cached_render_scene(cfg_scene, device=dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    raw, tree = root / "raw", root / "capture"
    t0 = time.perf_counter()
    write_scene_capture(scene, raw, applied_scale=APPLIED_SCALE)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(process_data, ["--data", raw / "images", "--data-semantic", raw / "masks",
                           "--transforms", raw / "transforms.json", "--output-dir", tree,
                           "--num-downscales", 1])
    process_s = time.perf_counter() - t0
    meta = json.loads((raw / "transforms.json").read_text())
    for fr in meta["frames"]:
        name = Path(fr["file_path"]).name
        fr["file_path"], fr["semantic_path"] = f"images/{name}", f"semantics/{Path(name).stem}.png"
    meta["semantics"] = ["apple", "stuff"]
    check(json.loads((tree / "transforms.json").read_text()) == meta,
          "process-data's transforms.json differs from a fresh merge")
    size = cfg_scene.image_size
    for d in ("images_2", "semantics_2"):
        files = sorted((tree / d).iterdir())
        check(len(files) == PRESET_CAMERAS
              and all(Image.open(f).size == (size // 2, size // 2) for f in files),
              f"process-data's {d}/")
    print(f"presets: the orchard at {PRESET_CAMERAS} cameras rendered in {render_s:.3f} s, "
          f"written as a raw capture in {write_s:.3f} s; process-data --num-downscales 1 "
          f"in {process_s:.3f} s; its transforms.json equals a fresh merge and images_2/, "
          f"semantics_2/ hold {PRESET_CAMERAS} frames at {size // 2}^2")
    return scene, tree, process_s


def train_capture(tag: str, tree: Path, run_dir: Path, argv: list, iters: int, hg,
                  counts: dict, spy=contextlib.nullcontext()) -> tuple:
    """``train --data <tree>`` with ``argv``, counted: -> (state, timings,
    manifest, the log's train records, final eval record, peak GiB, wall
    seconds). Checks the step count, finite losses and a rising train
    PSNR."""
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.scripts import train as train_cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_calls(trainer, "train_loop", hg, counts), \
            counted_calls(trainer, "evaluate_all", hg, counts), spy:
        state, timings = run_cli(train_cli, ["--data", tree, "--output-dir", run_dir,
                                             "--max-iters", iters, *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    manifest = json.loads((run_dir / "manifest.json").read_text())
    log = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in log if "total_loss" in r]
    final = [r for r in log if "final_eval_psnr" in r]
    keys = [k for k in LOSS_KEYS if k in train[0]]
    print(f"{tag}: train PSNR " + ", ".join(f"{r['psnr']:.3f} dB at {r['step']}" for r in train)
          + (f"; final eval PSNR {final[0]['final_eval_psnr']:.3f} dB" if final else ""))
    check(state.step == iters, f"{tag}: stopped at step {state.step} of {iters}")
    check(all(math.isfinite(r[k]) for r in train for k in keys), f"{tag}: a loss is not finite")
    check(train[-1]["psnr"] > train[0]["psnr"], f"{tag}: train PSNR did not rise")
    return state, timings, manifest, train, (final[0] if final else None), peak, wall


def eval_capture(tag: str, tree: Path, run_dir: Path, dev, hg, counts: dict) -> dict:
    """``eval`` of a capture run, counted, its stats finite."""
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.scripts import evaluate as eval_cli

    torch.cuda.reset_peak_memory_stats()
    with counted_calls(trainer, "evaluate_all", hg, counts):
        ev = run_cli(eval_cli, ["--load-dir", run_dir, "--data", tree])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: eval over the val split ({ev['num_images_evaluated']} cameras) on "
          f"{ev['device']}: PSNR {ev['psnr']:.3f} dB, SSIM {ev['ssim']:.4f}, IoU "
          f"{ev['iou']:.4f}, {ev['num_rays_per_sec']:.1f} rays/s; peak memory {peak:.3f} GiB; "
          f"launches {counts['evaluate_all'][-1]}")
    check(torch.device(ev["device"]).type == dev.type, f"{tag}: eval ran on {ev['device']}")
    check(all(math.isfinite(ev[k]) for k in ("psnr", "ssim", "iou")), f"{tag}: eval {ev}")
    return ev


def big_phase(scene, tree: Path, root: Path, process_s: float, dev, hg, name: str,
              seed: int) -> tuple[dict, list]:
    """``fruit_nerf_big`` (grid variant) at full width through ``train
    --data`` for BIG_ITERS steps with the sparsity prior, then ``eval``,
    ``export`` in DISK_BOX and ``count --gt-count``. -> (its K1/K2
    launches, the last step's two grid encodings' positions)."""
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf_big
    from fruitnerf_tpu_torch.engine.trainer import group_algorithms

    run_dir, counts = root / "big", {}
    captured = collections.deque(maxlen=2)  # the last step's fine samples and sparsity points
    state, timings, manifest, _, final, peak, wall = train_capture(
        "big", tree, run_dir, ["--preset", "fruit_nerf_big", "--sparsity-loss", 0.005,
                               "--seed", seed], BIG_ITERS, hg, counts,
        captured_positions(captured))
    cfg = apply_overrides(fruit_nerf_big(PRESET_CAMERAS), {"sparsity_loss": 0.005})
    algos = group_algorithms(state.optimizer)
    del state
    rays = BIG_ITERS * cfg.train_rays_per_batch / timings["train_s"]
    size = ORCHARD["image_size"]
    chunks = math.ceil(size * size / cfg.eval_rays_per_chunk)
    want = predicted_cell_launches(cfg, BIG_ITERS, BIG_ITERS // cfg.steps_per_eval * chunks)
    got = counts["train_loop"][0]
    print(f"big: train --preset fruit_nerf_big --data <capture> --max-iters {BIG_ITERS} "
          f"--sparsity-loss 0.005 in {wall:.3f} s on {name}: train_s {timings['train_s']:.3f} s "
          f"= {rays:.1f} rays/s ({rays / cfg.train_rays_per_batch:.3f} steps/s), eval_s "
          f"{timings['eval_s']:.3f}, save_s {timings['save_s']:.3f}; peak memory {peak:.3f} "
          f"GiB; {manifest['num_train_images']} train images of {PRESET_CAMERAS}; optimizer "
          f"groups {algos}; process-data {process_s:.3f} s")
    print(f"big: launches in train_loop {got}, predicted {want}")
    check(manifest["num_train_images"] == cfg.max_train_images == 200,
          f"big: {manifest['num_train_images']} train images")
    check(algos["fields"] == "radam", f"big: the fields group steps {algos['fields']}")
    check(got == want, "big: the K1/K2 launches differ from the prediction")
    check(final is not None and math.isfinite(final["final_eval_psnr"]), "big: no final eval")
    eval_capture("big", tree, run_dir, dev, hg, counts)
    probe_capture("big", run_dir, manifest, scene, cfg, dev, np.random.default_rng(seed))
    r = export_and_count("big", run_dir, manifest, scene, root / "big_export", hg, counts,
                         "cell_encode_fwd")
    print(f"big: seconds: train {wall:.3f}, export {r['export_s']:.3f}, count "
          f"{r['count_s']:.3f}")
    return summed(counts), list(captured)


def huge_phase(tree: Path, root: Path, dev, hg, name: str, seed: int) -> tuple[dict, list]:
    """``fruit_nerf_huge --variant parity`` at full width through ``train
    --data`` for HUGE_ITERS steps, then ``eval`` and ``export``. -> (its
    K3/K4 launches, the last step's three hash encodings' positions)."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_huge

    run_dir, counts = root / "huge", {}
    captured = collections.deque(maxlen=3)  # proposal 0, proposal 1, the fine samples
    _, timings, manifest, _, _, peak, wall = train_capture(
        "huge", tree, run_dir, ["--preset", "fruit_nerf_huge", "--variant", "parity",
                                "--seed", seed], HUGE_ITERS, hg, counts,
        captured_positions(captured, "grid_encode_flat"))
    cfg = dataclasses.replace(fruit_nerf_huge(PRESET_CAMERAS, variant="parity"),
                              max_iters=HUGE_ITERS)
    rays = HUGE_ITERS * cfg.train_rays_per_batch / timings["train_s"]
    size = ORCHARD["image_size"]
    chunks = math.ceil(size * size / cfg.eval_rays_per_chunk)
    want = predicted_hash_launches(cfg, range(HUGE_ITERS), HUGE_ITERS // cfg.steps_per_eval,
                                   chunks)
    got = counts["train_loop"][0]
    print(f"huge: train --preset fruit_nerf_huge --variant parity --data <capture> --max-iters "
          f"{HUGE_ITERS} in {wall:.3f} s on {name}: train_s {timings['train_s']:.3f} s = "
          f"{rays:.1f} rays/s ({rays / cfg.train_rays_per_batch:.3f} steps/s); peak memory "
          f"{peak:.3f} GiB; manifest hash entry {manifest['hash']['table_shape']}")
    print(f"huge: launches in train_loop {got}, predicted {want}")
    check(got == want, "huge: the K3/K4 launches differ from the prediction")
    eval_capture("huge", tree, run_dir, dev, hg, counts)
    export_and_count("huge", run_dir, manifest, None, root / "huge_export", hg, counts,
                     "corner_encode_fwd", count=False)
    return summed(counts), list(captured)


def tpu_phase(tree: Path, root: Path, dev, hg, name: str, seed: int) -> dict:
    """``fruit_nerf --variant tpu`` (the frequency field: no table, so no
    grid kernel) through ``train --data`` for TPU_ITERS steps and its final
    eval."""
    run_dir, counts = root / "tpu", {}
    _, timings, manifest, _, final, peak, wall = train_capture(
        "tpu", tree, run_dir, ["--preset", "fruit_nerf", "--variant", "tpu", "--seed", seed],
        TPU_ITERS, hg, counts)
    rays = TPU_ITERS * 4096 / timings["train_s"]
    launches = summed(counts)
    print(f"tpu: train --preset fruit_nerf --variant tpu --data <capture> --max-iters "
          f"{TPU_ITERS} in {wall:.3f} s on {name}: {rays:.1f} rays/s; peak memory {peak:.3f} "
          f"GiB; manifest table {manifest.get('table', 'recorded')}; grid kernel launches "
          f"{launches}")
    check("table" in manifest and manifest["table"] is None, "tpu: the manifest records a table")
    check(not any(launches.values()), "tpu: a grid kernel was launched")
    check(final is not None and math.isfinite(final["final_eval_psnr"]), "tpu: no final eval")
    return launches


def presets_phase(dev, hg, name: str, seed: int) -> dict:
    """The big, huge and tpu phases on one processed capture, the tools
    phase on their runs, and K1/K2 at the big step's positions and K3/K4 at
    the huge step's, each at its own layout. -> {"big", "huge", "tpu":
    launches; "big_step", "huge_step": the kernel pairs' numbers there;
    "tools": the tools phase's}."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_big, fruit_nerf_huge

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scene, tree, process_s = write_processed_capture(dev, root)
        big, big_pos = big_phase(scene, tree, root, process_s, dev, hg, name, seed)
        huge, huge_pos = huge_phase(tree, root, dev, hg, name, seed)
        tpu = tpu_phase(tree, root, dev, hg, name, seed)
        tools = tools_phase(scene, tree, root, dev, hg, seed)
    layout = fruit_nerf_big(1).model.field.grid.cell_layout()
    big_step = step_layout(lambda t, p, gr, label: cell_pair(hg, layout, label, t, p, gr),
                           layout, 16, 2 * layout.num_levels, big_pos, dev, seed,
                           "K1/K2 big (16 levels x 16384 rows, 16..4096)")
    huge_step = hash_step_layouts(hg, fruit_nerf_huge(1, variant="parity"), huge_pos, dev, seed)
    return {"big": big, "huge": huge, "tpu": tpu, "big_step": big_step, "huge_step": huge_step,
            "tools": tools}


# ---------------------------------------------------------------------------
# the tools: suggest-crop, the RGB point cloud, the viewer, the device DBSCAN
# engine, speed-probe, profiling
# ---------------------------------------------------------------------------

TOOLS_GRID = 128  # suggest-crop's probe grid: 128^2 rays of 128 samples, one batch
POINTCLOUD_CAMERAS = 12
POINTCLOUD_POINTS = 200_000  # the export's --num-points, of 12 x 256^2 pixels: keeps its
# outlier counts (native, on the host) short
VIEW_SIZE = 256  # viewer frames: 2 render chunks each at 32768 rays a chunk
SHELL_POINTS = 4200  # a synthetic fruit shell's points: 120 shells, 504,000 points
SPEED_CANDIDATES = "default_mid4096f4,uniform_T8192"
TRACE_STEPS = 5


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _get(url: str) -> tuple[bytes, float]:
    """GET from the viewer on this machine: -> (body, seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as r:
        check(r.status == 200, f"tools: viewer {url} answered {r.status}")
        body = r.read()
    return body, time.perf_counter() - t0


def suggest_crop_tool(run_dir: Path, root: Path, manifest: dict, scene: dict, hg,
                      counts: dict) -> dict:
    """``suggest-crop --grid TOOLS_GRID`` on a capture run: more than half
    of the GT fruit centres (in the probe frame) inside the semantic AABB,
    K1 once a probe batch."""
    from fruitnerf_tpu_torch.scripts import suggest_crop

    with counted_calls(suggest_crop, "occupancy_grids", hg, counts):
        t0 = time.perf_counter()
        report = run_cli(suggest_crop, ["--load-dir", run_dir, "--output-dir", root / "crop",
                                        "--grid", TOOLS_GRID])
        seconds = time.perf_counter() - t0
    gt, _ = gt_in_capture(manifest, scene)
    gt_box = gt * manifest["dataparser_scale"] / APPLIED_SCALE / 2.0  # the probe frame
    box = report["semantic_aabb"]
    check(box is not None, "tools: suggest-crop found no semantic cell")
    lo, hi = np.asarray(box)
    inside = float(((gt_box >= lo) & (gt_box <= hi)).all(1).mean())
    batches = math.ceil(TOOLS_GRID**2 / 16384)
    got = counts["occupancy_grids"][-1]
    print(f"tools: suggest-crop --grid {TOOLS_GRID} on the big run in {seconds:.3f} s: "
          f"{report['density_cells']} density and {report['semantic_cells']} semantic cells, "
          f"semantic AABB {box}; {inside:.4f} of the {len(gt)} GT fruit centres inside; "
          f"launches {_nonzero(got)} for {batches} probe batches")
    check(inside > 0.5, f"tools: only {inside:.2%} of the GT centres lie in the semantic AABB")
    check(got["cell_encode_fwd"] == batches and sum(got.values()) == batches,
          f"tools: suggest-crop launched {got} for {batches} batches")
    check(len(report["projections"]) == 3, "tools: suggest-crop wrote no projections")
    return {"suggest_crop_s": seconds, "gt_inside": inside}


def rgb_pointcloud_tool(run_dir: Path, tree: Path, root: Path, cfg, hg, counts: dict) -> dict:
    """``export --mode pointcloud --data <capture>`` on a capture run,
    subsampled to POINTCLOUD_POINTS: a non-empty finite cloud with colours
    in [0, 1]; K1 once a render chunk of each camera."""
    from fruitnerf_tpu_torch import native
    from fruitnerf_tpu_torch.export import ply, rgb_pointcloud
    from fruitnerf_tpu_torch.scripts import export as export_cli

    cleaning = []  # seconds of the native outlier counts
    real_counts = native.neighbor_counts

    def timed_counts(*a):
        t0 = time.perf_counter()
        try:
            return real_counts(*a)
        finally:
            cleaning.append(time.perf_counter() - t0)

    native.neighbor_counts = timed_counts
    try:
        with counted_calls(rgb_pointcloud, "export_rgb_pointcloud", hg, counts):
            t0 = time.perf_counter()
            out = run_cli(export_cli, ["--load-dir", run_dir, "--output-dir", root / "rgb",
                                       "--mode", "pointcloud", "--data", tree,
                                       "--pointcloud-cameras", POINTCLOUD_CAMERAS,
                                       "--num-points", POINTCLOUD_POINTS])
            seconds = time.perf_counter() - t0
    finally:
        native.neighbor_counts = real_counts
    pts, cols = out["points"], out["colors"]
    size = ORCHARD["image_size"]
    chunks = POINTCLOUD_CAMERAS * math.ceil(size * size / cfg.eval_rays_per_chunk)
    got = counts["export_rgb_pointcloud"][-1]
    written = ply.read_ply(out["path"])["points"]
    print(f"tools: export --mode pointcloud of {POINTCLOUD_CAMERAS} cameras at {size}^2 to "
          f"{POINTCLOUD_POINTS} points in {seconds:.3f} s (native outlier counts "
          f"{sum(cleaning):.3f} s): {len(pts)} points, extent {pts.min(0).round(3).tolist()}.."
          f"{pts.max(0).round(3).tolist()}; launches {_nonzero(got)} for {chunks} chunks")
    check(0 < len(pts) <= POINTCLOUD_POINTS and np.isfinite(pts).all(),
          "tools: the RGB cloud is empty, too large or not finite")
    check(cols.min() >= 0.0 and cols.max() <= 1.0, "tools: an RGB colour lies outside [0, 1]")
    check(len(written) == len(pts), "tools: point_cloud.ply holds another cloud")
    check(got["cell_encode_fwd"] == chunks and sum(got.values()) == chunks,
          f"tools: the RGB cloud launched {got} for {chunks} chunks")
    return {"pointcloud_s": seconds, "cleaning_s": sum(cleaning), "pointcloud_points": len(pts)}


def viewer_tool(big_dir: Path, huge_dir: Path, dev, hg, counts: dict) -> dict:
    """The viewer on the big run through HTTP on this machine (/, /info,
    /render of each panel full, preview and with a crop box, /suggest),
    and one frame of the huge parity run (K3). Frames at VIEW_SIZE^2 launch
    K1 (or K3 in each of huge's three fields) once a render chunk."""
    from PIL import Image

    from fruitnerf_tpu_torch.scripts import suggest_crop
    from fruitnerf_tpu_torch.viewer import server

    session = server.ViewerSession.from_run_dir(big_dir, dev)
    chunks = math.ceil(VIEW_SIZE**2 / session.config.eval_rays_per_chunk)
    httpd = server.serve(session, port=0)
    try:
        host, port = httpd.server_address
        url = f"http://{host}:{port}"
        page, _ = _get(url + "/")
        info = json.loads(_get(url + "/info")[0])
        check(b"/render?" in page and info["preset"] == "fruit_nerf_big",
              f"tools: viewer page or /info {info}")
        seconds = {}
        with counted_calls(server.ViewerSession, "render_frame", hg, counts):
            for panel in server._PANELS:
                for tag, q in (("full", ""), ("preview", "&preview=1"),
                               ("crop", "&crop=-0.3,-0.3,-0.5,0.3,0.3,0.1")):
                    body, s = _get(f"{url}/render?theta=0.8&phi=0.5&radius=1.2&size="
                                   f"{VIEW_SIZE}&panel={panel}{q}")
                    img = np.asarray(Image.open(io.BytesIO(body)))
                    check(img.shape == (VIEW_SIZE, VIEW_SIZE, 3), f"tools: frame {img.shape}")
                    seconds.setdefault(tag, []).append(s)
        with counted_calls(suggest_crop, "occupancy_grids", hg, counts):
            aabb = json.loads(_get(url + "/suggest")[0])["aabb"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    frames = counts["render_frame"]
    check(all(c["cell_encode_fwd"] == chunks and sum(c.values()) == chunks for c in frames),
          f"tools: viewer frames launched {frames[0]} for {chunks} chunks")
    check(aabb is not None, "tools: the viewer's /suggest found nothing")
    huge = server.ViewerSession.from_run_dir(huge_dir, dev)
    with counted_calls(server.ViewerSession, "render_frame", hg, counts):
        t0 = time.perf_counter()
        huge.render_frame(0.8, 0.5, 1.2, VIEW_SIZE)
        huge_s = time.perf_counter() - t0
    got = counts["render_frame"][-1]
    want = chunks * (1 + len(huge.config.model.proposal_nets))
    means = {k: float(np.mean(v)) for k, v in seconds.items()}
    print(f"tools: viewer on the big run at {VIEW_SIZE}^2, seconds a frame over the "
          f"{len(server._PANELS)} panels (with the HTTP round trip): " +
          ", ".join(f"{k} {v:.4f}" for k, v in means.items()) +
          f"; /suggest {aabb}; huge parity frame {huge_s:.4f} s, launches {_nonzero(got)}")
    check(got["corner_encode_fwd"] == want and sum(got.values()) == want,
          f"tools: the huge frame launched {got}, predicted {want} K3")
    return {"viewer_s_a_frame": means, "viewer_huge_s": huge_s}


def fruit_shells(manifest: dict, scene: dict, rng) -> tuple[np.ndarray, float]:
    """SHELL_POINTS points on each GT fruit's surface (2% radial jitter), in
    the export's output frame: -> (points, fruit radius there)."""
    gt, r_world = gt_in_capture(manifest, scene)
    r_out = r_world / APPLIED_SCALE
    d = rng.standard_normal((len(gt), SHELL_POINTS, 3))
    d *= r_out * (1 + 0.02 * rng.standard_normal((len(gt), SHELL_POINTS, 1))) \
        / np.linalg.norm(d, axis=-1, keepdims=True)
    return (gt[:, None] / APPLIED_SCALE + d).reshape(-1, 3).astype(np.float32), r_out


def dbscan_tool(cloud: np.ndarray, label: str, eps: float, min_samples: int, radius: float,
                nb_points: int, dev) -> dict:
    """``dbscan_device`` and ``radius_neighbor_mask_device`` on the card
    against the native engine on one cloud: the same noise set, core labels
    and mask; seconds of each (host bucketing included; the device's
    second call)."""
    from fruitnerf_tpu_torch import native
    from fruitnerf_tpu_torch.counting.dbscan_device import (
        _bucket,
        dbscan_device,
        radius_neighbor_mask_device,
    )

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dbscan_device(cloud[:1000], eps, min_samples, dev)  # warm the ops
    labels, dev_s = timed(dbscan_device, cloud, eps, min_samples, dev)
    mask, mask_s = timed(radius_neighbor_mask_device, cloud, radius, nb_points, dev)
    ref, nat_s = timed(native.dbscan, cloud, eps, min_samples)
    ref_mask, nat_mask_s = timed(native.radius_outlier_mask, cloud, radius, nb_points)
    check(labels is not None and ref is not None and mask is not None and ref_mask is not None,
          f"tools: {label}: an engine gave no answer")
    same_noise = bool(((labels == -1) == (ref == -1)).all())
    core = native.radius_outlier_mask(cloud, eps, min_samples)  # >= min_samples within eps
    same_core = bool((labels[core] == ref[core]).all())
    same_mask = bool((mask == ref_mask).all())
    b = _bucket(cloud, eps)
    print(f"tools: dbscan on {label} ({len(cloud)} points, eps {eps:.5g}, min_samples "
          f"{min_samples}; {b['num_cells']} cells of up to {b['k']}): device {dev_s:.4f} s, "
          f"native {nat_s:.4f} s, {len(set(ref[ref >= 0]))} clusters, {int((ref == -1).sum())} "
          f"noise; radius mask (r {radius:.5g}, {nb_points}): device {mask_s:.4f} s, native "
          f"{nat_mask_s:.4f} s, {int(ref_mask.sum())} kept; same noise {same_noise}, same core "
          f"labels {same_core}, same mask {same_mask}")
    check(same_noise and same_core and same_mask, f"tools: {label}: the device engine differs "
          "from the native engine")
    return {"points": len(cloud), "device_s": dev_s, "native_s": nat_s, "mask_device_s": mask_s,
            "mask_native_s": nat_mask_s}


def speed_probe_tool(root: Path, hg, counts: dict) -> dict:
    """``speed-probe --only SPEED_CANDIDATES`` at small repeat counts."""
    from fruitnerf_tpu_torch.scripts import speed_probe, step_bench

    with counted_calls(step_bench, "step_ms", hg, counts):
        rows = run_cli(speed_probe, ["--only", SPEED_CANDIDATES, "--chunk", 5, "--reps", 2,
                                     "--repeats", 3, "--output", root / "speed_probe.json"])
    check([r["name"] for r in rows] == SPEED_CANDIDATES.split(","), "tools: speed-probe rows")
    for r in rows:
        print(f"tools: speed-probe {r['name']}: {r['ms_per_step']:.4f} ms a step (min "
              f"{r['ms_per_step_min']:.4f}), {r['rays_per_sec']:.1f} rays/s, "
              f"{r['vs_baseline']:.4f} x the 136,533 rays/s anchor; {r['card']}")
        check(math.isfinite(r["rays_per_sec"]) and r["rays_per_sec"] > 0, "tools: speed-probe")
    return {r["name"]: r["rays_per_sec"] for r in rows}


def profiling_tool(root: Path, dev, hg, counts: dict) -> dict:
    """TRACE_STEPS grid train steps on a small scene under ``device_trace``,
    each timed by ``StepTimer`` (synchronised on the parameters it updates):
    a Chrome trace with the cell kernels in it, and the section's mean."""
    from fruitnerf_tpu_torch.configs import fruit_nerf
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, train_step
    from fruitnerf_tpu_torch.utils.profiling import StepTimer, device_trace

    data = dataset_from_scene(render_scene(SyntheticSceneConfig(image_size=64, num_cameras=8),
                                           device=dev), dev)
    cfg = fruit_nerf(8)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, 8, dev, generator=gen)
    train_step(state, data, cfg, gen)  # warm
    timer = StepTimer()
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    with device_trace(root / "trace") as prof:
        for _ in range(TRACE_STEPS):
            with timer.section("train_step", block_on=state.params):
                train_step(state, data, cfg, gen)
    counts.setdefault("trace", []).append(dict(hg.LAUNCHES))
    trace = root / "trace" / "trace.json"
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    kernels = sorted(n for n in names if "cell_encode" in n)
    device_ms = sum(getattr(r, "self_device_time_total", 0) for r in prof.key_averages()) / 1e3
    report = timer.report()
    print(f"tools: StepTimer over {TRACE_STEPS} grid steps: {report}; device_trace wrote "
          f"{trace.stat().st_size} bytes, {len(names)} event names, cell kernels {kernels}, "
          f"{device_ms:.3f} device ms self time; launches {_nonzero(counts['trace'][-1])}")
    check(timer.counts["train_step"] == TRACE_STEPS and report["train_step"] > 0,
          "tools: StepTimer")
    check(len(kernels) >= 2, "tools: the trace holds no cell kernel")
    check(counts["trace"][-1]["cell_encode_fwd"] == TRACE_STEPS, "tools: traced launches")
    return {"step_ms": report["train_step"], "trace_bytes": trace.stat().st_size}


def tools_phase(scene: dict, tree: Path, root: Path, dev, hg, seed: int) -> dict:
    """The tools on the presets phase's runs (``root/big``, ``root/huge``)
    and capture (``tree``): suggest-crop, export --mode pointcloud, the
    viewer, the device DBSCAN engine on the big run's fruit cloud and on
    120 synthetic fruit shells, speed-probe, StepTimer and device_trace.
    -> {"launches": summed over the phase, and each tool's numbers}."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_big
    from fruitnerf_tpu_torch.export.ply import read_ply

    t_start = time.perf_counter()
    counts: dict = {}
    big_dir = root / "big"
    manifest = json.loads((big_dir / "manifest.json").read_text())
    out = {"suggest_crop": suggest_crop_tool(big_dir, root, manifest, scene, hg, counts),
           "pointcloud": rgb_pointcloud_tool(big_dir, tree, root, fruit_nerf_big(1), hg, counts),
           "viewer": viewer_tool(big_dir, root / "huge", dev, hg, counts)}
    fruit = read_ply(root / "big_export" / "semantic_colormap.ply")["points"]
    _, r_world = gt_in_capture(manifest, scene)
    r_out = r_world / APPLIED_SCALE
    shells, _ = fruit_shells(manifest, scene, np.random.default_rng(seed))
    out["dbscan"] = {
        "fruit_cloud": dbscan_tool(fruit, "the big run's fruit cloud", 0.6 * r_out, 4,
                                   0.45 * r_out, 3, dev),
        "shells": dbscan_tool(shells, "120 fruit shells", 0.3 * r_out, 10, 0.3 * r_out, 10,
                              dev)}
    out["speed_probe"] = speed_probe_tool(root, hg, counts)
    out["profiling"] = profiling_tool(root, dev, hg, counts)
    out["launches"] = summed(counts)
    out["seconds"] = time.perf_counter() - t_start
    print(f"tools: every tool passed in {out['seconds']:.3f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# scale-out: the scene axis of K1-K4, the multi-scene campaign, data
# parallelism over torch.distributed, --mesh
# ---------------------------------------------------------------------------

SCENES = 4  # the scene-batched kernels' and the campaign's scenes
CAMPAIGN_ITERS = 200  # the grid campaign's steps (the JAX docstring's 4000, cut; 400
# until the orchard phase counted)
CAMPAIGN_PARITY_ITERS = 60  # the parity campaign's steps: batched K3/K4 on their path
SINGLE_SCENE_STEPS = 50  # steps of one scene alone, timed beside the campaign
DP_STEPS = 5
DP_RAYS = 4096  # 2048 a rank
MESH_ITERS = 100  # the run that eval, render and export --mesh restore
# the campaigns: the JAX docstring's command at full width (its steps cut
# to CAMPAIGN_ITERS), and the parity variant on fewer cameras
GRID_CAMPAIGN = ["--num-fruits", "8", "--num-cameras", "80", "--image-size", "128",
                 "--preset", "fruit_nerf", "--variant", "grid",
                 "--train-rays-per-batch", "2048", "--export-n", "192"]
PARITY_CAMPAIGN = ["--num-fruits", "8", "--num-cameras", "40", "--image-size", "128",
                   "--preset", "fruit_nerf", "--variant", "parity",
                   "--train-rays-per-batch", "2048", "--export-n", "64"]
RENDER_MESH_ATOL = 1e-5  # two shards on one card against one: cuBLAS may pick other kernels
# 2 ranks against 1, each of DP_SEEDS. The first step's losses within the
# JAX package's 1-vs-N bound (__graft_entry__.py:130, one step). After it
# the runs part: the averaged gradient rounds apart from the one-rank one,
# and Adam's first step moves an entry by lr * g / (|g| + 1e-15), a full lr
# either way wherever g is rounding noise. So after the first step the
# parameters more than DP_PARAM_ATOL apart must be entries whose one-rank
# gradient is within DP_FLIP_REL_G of their leaf's largest, each at most
# two full steps (2 * DP_MAX_LR) apart; the later losses are held to
# DP_DRIFT_RTOL. A planted fault (the gradient of rank 0's shard alone,
# rank 1's dropped) must break these checks. On an H100 the three seeds
# read at most 1.22e-4 after the first step, the planted fault 2.89e-3 to
# 7.79e-3 by the fifth; DP_DRIFT_RTOL sits near their geometric middle.
DP_SEEDS = (0, 1, 2)
DP_FIRST_RTOL = 2e-5
DP_DRIFT_RTOL = 6e-4
DP_PARAM_ATOL = 1e-6
DP_FLIP_REL_G = 1e-3
DP_MAX_LR = 1e-2  # the largest lr_init of the grid preset's groups


def vmap_rule(hg, layout, feats: int, corner: bool):
    """The kernel pair through its autograd Functions under ``torch.func``,
    as the multi-scene step runs them: ``vmap`` of a ``vjp``, so the
    forward Function's ``vmap`` rule launches K1/K3 and the backward
    Function's launches K2/K4, once for every scene. -> f(tables [S, ...],
    pos [S, P, 3], grad [S, P, C]) -> (out, dTable, dPos), [S, ...] each."""
    def enc(t, p):
        if corner:
            return hg._CornerEncodeCUDA.apply(t, p, layout, feats)
        return hg._CellEncodeCUDA.apply(t, p, layout)

    def one(t, p, g):
        out, pull = torch.func.vjp(enc, t, p)
        return (out, *pull(g))

    return torch.func.vmap(one)


def hold_scenes(hg, label, fwd, bwd, plain, tables, pos, grad, layout, feats: int,
                corner: bool, passes: bool = False) -> dict:
    """A scene-batched kernel pair at S = tables.shape[0], launched directly
    and through the autograd Functions' ``vmap`` rules (``vmap_rule``):
    each scene of both bitwise equal to a launch of that scene alone
    (forward, dTable, dPos), and within FWD_ATOL / BWD_RTOL of the plain
    version; median times of the batched launch, of the S single launches,
    of the plain version over the S scenes and of one ``embedding_bag``
    over the S·P·L rows; the bound is S single launches' bytes (and
    operations); with ``passes``, the batched backward's passes."""
    import torch.nn.functional as F

    s_n, p = tables.shape[0], pos.shape[1]
    direct = (fwd(tables, pos), *bwd(tables, pos, grad))
    out, dt, dp = vmap_rule(hg, layout, feats, corner)(tables, pos, grad)
    singles = [(fwd(tables[s], pos[s]), *bwd(tables[s], pos[s], grad[s])) for s in range(s_n)]
    torch.cuda.synchronize()
    bitwise = all(torch.equal(b[s], x) for s, one in enumerate(singles)
                  for b, x in zip(direct, one))
    rule_bitwise = all(torch.equal(b[s], x) for s, one in enumerate(singles)
                       for b, x in zip((out, dt, dp), one))
    leaves, graphs = [], []
    fwd_err = dt_rel = dp_rel = 0.0
    dt_err = dp_err = 0.0
    for s in range(s_n):
        t_ = tables[s].clone().requires_grad_(True)
        p_ = pos[s].clone().requires_grad_(True)
        ref = plain(t_, p_)
        g_t, g_p = torch.autograd.grad(ref, (t_, p_), grad[s], retain_graph=True)
        fwd_err = max(fwd_err, (out[s] - ref).abs().max().item())
        dt_err = max(dt_err, (dt[s] - g_t).abs().max().item())
        dp_err = max(dp_err, (dp[s] - g_p).abs().max().item())
        dt_rel = max(dt_rel, (dt[s] - g_t).abs().max().item() / g_t.abs().max().item())
        dp_rel = max(dp_rel, (dp[s] - g_p).abs().max().item() / g_p.abs().max().item())
        leaves.append((t_, p_))
        graphs.append(ref)
    print(f"scale-out: {label}: scenes of one launch bitwise equal to single launches: "
          f"{bitwise}, through the vmap rules: {rule_bitwise}; the vmap rules' forward max abs "
          f"err {fwd_err:.3e} (tol {FWD_ATOL:g}); dTable {dt_rel:.3e}, dPos {dp_rel:.3e} of "
          f"their max (tol {BWD_RTOL:g})")
    check(bitwise, f"{label}: a scene of the batched launch differs from its single launch")
    check(rule_bitwise, f"{label}: a scene through the vmap rules differs from its single launch")
    check(fwd_err <= FWD_ATOL, f"{label} forward error {fwd_err} > {FWD_ATOL}")
    check(dt_rel <= BWD_RTOL and dp_rel <= BWD_RTOL, f"{label} backward error over {BWD_RTOL}")

    # the yardstick: one embedding_bag over every scene's rows of the
    # stacked table, the S scenes' indices offset by their tables
    rows = tables.shape[1] * (8 if not corner else 1)
    idx, w = zip(*(bag_inputs(hg, pos[s], layout, corner) for s in range(s_n)))
    idx = torch.cat([i + s * rows for s, i in enumerate(idx)])
    w = torch.cat(w)
    weight = tables.reshape(-1, feats if corner else 2)

    def lib_fwd():
        return F.embedding_bag(idx, weight, mode="sum", per_sample_weights=w)

    leaf = weight.detach().clone().requires_grad_(True)
    lib_graph = F.embedding_bag(idx, leaf, mode="sum", per_sample_weights=w)
    lib_grad = grad.reshape(lib_graph.shape)
    lf_err = (lib_fwd().view(out.shape) - torch.stack(graphs)).abs().max().item()
    check(lf_err <= FWD_ATOL, f"{label}: the embedding_bag yardstick computes another function")
    costs = [work(hg, pos[s], layout, feats, corner) for s in range(s_n)]
    n = 10
    times = {
        "fwd_ms": median_ms(lambda: fwd(tables, pos), n),
        "bwd_ms": median_ms(lambda: bwd(tables, pos, grad), n),
        "fwd_singles_ms": median_ms(lambda: [fwd(tables[s], pos[s]) for s in range(s_n)], n),
        "bwd_singles_ms": median_ms(
            lambda: [bwd(tables[s], pos[s], grad[s]) for s in range(s_n)], n),
        "fwd_plain_ms": median_ms(lambda: [plain(tables[s], pos[s]) for s in range(s_n)], n),
        "bwd_plain_ms": median_ms(lambda: [torch.autograd.grad(
            graphs[s], leaves[s], grad[s], retain_graph=True) for s in range(s_n)], n),
        "fwd_library_ms": median_ms(lib_fwd, n),
        "bwd_library_ms": median_ms(
            lambda: torch.autograd.grad(lib_graph, leaf, lib_grad, retain_graph=True), n),
    }
    r = {"fwd_err": fwd_err, "bwd_err": max(dt_err, dp_err), "scenes": s_n,
         "points_per_scene": p, **times}
    for d in ("fwd", "bwd"):
        b = bound(sum(c[d]["bytes"] for c in costs), sum(c[d]["ops"] for c in costs))
        r[f"{d}_bound_ms"], r[f"{d}_bound_by"] = b["bound_ms"], b["bound_by"]
    if passes:
        r["bwd_passes"] = backward_passes(hg, label, lambda: bwd(tables, pos, grad), pos,
                                          layout, feats, corner)
    print(f"scale-out: {label}: forward {times['fwd_ms']:.4f} ms for {s_n} scenes, "
          f"{s_n} single launches {times['fwd_singles_ms']:.4f}, plain "
          f"{times['fwd_plain_ms']:.4f}, embedding_bag {times['fwd_library_ms']:.4f}, bound "
          f"{r['fwd_bound_ms']:.4f}; backward {times['bwd_ms']:.4f}, singles "
          f"{times['bwd_singles_ms']:.4f}, plain {times['bwd_plain_ms']:.4f}, embedding_bag "
          f"{times['bwd_library_ms']:.4f}, bound {r['bwd_bound_ms']:.4f} (medians)")
    return r


def scene_kernels(hg, dev, seed: int) -> list[dict]:
    """K1/K2 at the ``fruit_nerf`` two-tier layout and K3/K4 at the parity
    variant's main field (16 x 2^19, F = 2), SCENES scenes of P_SLICE
    uniform-random points each, batched in one launch -> their kernels-JSON
    entries (launches filled in by the campaigns)."""
    from fruitnerf_tpu_torch.configs import fruit_nerf

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    cell = fruit_nerf(1).model.field.grid.cell_layout()
    main = fruit_nerf(1, variant="parity").model.field.hash
    corner = hg.corner_layout(main.level_resolutions(), main.table_size)
    f = main.features_per_level
    out = []
    for name, layout, width, feats, is_corner, fwd, bwd, plain, line, src, fns in (
        ("cell_encode", cell, 16, 2, False,
         lambda t, p: hg.cell_encode_fwd_cuda(t, p, cell),
         lambda t, p, gr: hg.cell_encode_bwd_cuda(t, p, gr, cell, True),
         lambda t, p: hg.cell_encode_torch(t, p, cell), (523, 581), CELL_SRC,
         ("cell_encode_fwd_kernel", "cell_encode_bwd_kernel")),
        ("corner_encode", corner, f, f, True,
         lambda t, p: hg.corner_encode_fwd_cuda(t, p, corner, f),
         lambda t, p, gr: hg.corner_encode_bwd_cuda(t, p, gr, corner, f, True),
         lambda t, p: hg.grid_encode_corner_torch(t, p, corner, f), (163, 203), CORNER_SRC,
         ("corner_encode_fwd_kernel", "corner_encode_bwd_kernel")),
    ):
        tables = torch.rand((SCENES, layout.total_rows, width), generator=g, device=dev) * 2 - 1
        pos = torch.rand((SCENES, P_SLICE, 3), generator=g, device=dev) * 0.98 + 0.01
        grad = torch.randn((SCENES, P_SLICE, feats * layout.num_levels), generator=g,
                           device=dev)
        label = (f"{name} x {SCENES} scenes ({layout.num_levels} levels, "
                 f"{layout.total_rows} rows, P {P_SLICE} a scene)")
        r = hold_scenes(hg, label, fwd, bwd, plain, tables, pos, grad, layout, feats, is_corner,
                        passes=True)
        for e, d in zip(_entries(r, (f"{name}_fwd_scenes", f"{name}_bwd_scenes"), src, fns,
                                 line), ("fwd", "bwd")):
            e.update(scenes=SCENES, points_per_scene=P_SLICE,
                     single_launches_ms=r[f"{d}_singles_ms"])
            out.append(e)
        del tables, pos, grad
    return out


@contextlib.contextmanager
def scene_operands(hg, sink: list, batched: bool = True):
    """Record a copy of the operands of every scene-batched K2/K4 launch in
    the block (of every K2/K4 launch, without ``batched``), as the backward
    Functions (or their ``vmap`` rules) hand them over: (corner, tables
    [S, ...] or one, positions [S, P, 3] or [P, 3], grad, layout,
    features). The same call site's K1/K3 took the same tables and
    positions. The block's train steps run eagerly."""
    real = {"cell": hg.cell_encode_bwd_cuda, "corner": hg.corner_encode_bwd_cuda}

    def cell(table, positions, grad, layout, needs_pos_grad):
        if positions.dim() == 3 or not batched:
            sink.append((False, table.clone(), positions.clone(), grad.clone(), layout, 2))
        return real["cell"](table, positions, grad, layout, needs_pos_grad)

    def corner(table, positions, grad, layout, features, needs_pos_grad):
        if positions.dim() == 3 or not batched:
            sink.append((True, table.clone(), positions.clone(), grad.clone(), layout, features))
        return real["corner"](table, positions, grad, layout, features, needs_pos_grad)

    hg.cell_encode_bwd_cuda, hg.corner_encode_bwd_cuda = cell, corner
    try:
        with eager_steps():
            yield
    finally:
        hg.cell_encode_bwd_cuda, hg.corner_encode_bwd_cuda = real["cell"], real["corner"]


@contextlib.contextmanager
def recorded_steps(module, hg, losses: list, counts: dict, iters: int, operands: list):
    """Wrap ``module.multi_scene_step`` for the block: the launch counts are
    set to 0 before its first call and read after each; every step's
    per-scene total losses are kept (on the device); the last step's
    scene-batched kernel operands go to ``operands`` (``scene_operands``)."""
    real = module.multi_scene_step

    def wrapped(*args, **kwargs):
        if not losses:
            torch.cuda.synchronize()
            hg.reset_launch_counts()
        last = len(losses) == iters - 1
        with scene_operands(hg, operands) if last else contextlib.nullcontext():
            m = real(*args, **kwargs)
        losses.append(m["total_loss"].detach().clone())
        counts["launches"], counts["scenes"] = dict(hg.LAUNCHES), dict(hg.SCENES)
        return m

    module.multi_scene_step = wrapped
    try:
        yield
    finally:
        module.multi_scene_step = real


def campaign_run(hg, name: str, argv: list, iters: int, root: Path) -> dict:
    """``multi-scene`` through its entry point: finite per-scene losses that
    fall, a report row a scene, the grid kernels launched once a call for
    all scenes. -> the report, the step losses [iters, S] and the counts."""
    from fruitnerf_tpu_torch.parallel import multi_scene as ms
    from fruitnerf_tpu_torch.scripts import multi_scene_campaign as campaign

    parser = argparse.ArgumentParser()
    campaign.add_args(parser)
    args = parser.parse_args([*argv, "--scenes", str(SCENES), "--iters", str(iters),
                              "--output-dir", str(root)])
    losses, counts, operands = [], {}, []
    t0 = time.perf_counter()
    with recorded_steps(ms, hg, losses, counts, iters, operands):
        report = campaign.main(args)
    wall = time.perf_counter() - t0
    steps = torch.stack(losses).double().cpu().numpy()  # [iters, S]
    k = min(20, iters // 4)
    first, last = steps[:k].mean(0), steps[-k:].mean(0)
    print(f"scale-out: multi-scene {' '.join(argv)} --iters {iters} on {name} in {wall:.3f} s: "
          f"train {report['train_s']} s, {report['train_rays_per_sec_all_scenes']} rays/s all "
          f"scenes; loss of the first {k} steps {np.round(first, 4).tolist()}, of the last "
          f"{np.round(last, 4).tolist()}; rows {report['scenes']}; launches of the steps "
          f"{counts['launches']}, scenes {counts['scenes']}")
    check(steps.shape == (iters, SCENES) and bool(np.isfinite(steps).all()),
          "a campaign loss is not finite")
    check(bool((last < first).all()), "a campaign scene's loss did not fall")
    check(len(report["scenes"]) == SCENES, "the campaign report lacks a scene's row")
    check(report["device"] == name, f"the campaign ran on {report['device']}")
    return {"report": report, "counts": counts, "wall_s": wall, "operands": operands}


def campaign_kernels(hg, tag: str, operands: list) -> tuple[dict, dict]:
    """``hold_scenes`` on each scene-batched call of a campaign's last step,
    at its own operands (the trained tables, the step's positions and
    output gradients) -> ({site: numbers} of the forward, of the backward),
    the sites of one kernel family each (the other's empty)."""
    sites = ({}, {})
    for i, (corner, tables, pos, grad, layout, f) in enumerate(operands):
        if corner:
            fwd = lambda t, p, lo=layout, f=f: hg.corner_encode_fwd_cuda(t, p, lo, f)  # noqa: E731
            bwd = lambda t, p, gr, lo=layout, f=f: hg.corner_encode_bwd_cuda(  # noqa: E731
                t, p, gr, lo, f, True)
            plain = lambda t, p, lo=layout, f=f: hg.grid_encode_corner_torch(t, p, lo, f)  # noqa: E731
        else:
            fwd = lambda t, p, lo=layout: hg.cell_encode_fwd_cuda(t, p, lo)  # noqa: E731
            bwd = lambda t, p, gr, lo=layout: hg.cell_encode_bwd_cuda(t, p, gr, lo, True)  # noqa: E731
            plain = lambda t, p, lo=layout: hg.cell_encode_torch(t, p, lo)  # noqa: E731
        site = (f"{tag} step call {i} ({layout.num_levels} levels, {layout.total_rows} rows, "
                f"P {pos.shape[1]} a scene)")
        r = hold_scenes(hg, f"{'K3/K4' if corner else 'K1/K2'} at the {site}", fwd, bwd, plain,
                        tables, pos, grad, layout, f, corner)
        for side, d in zip(sites, ("fwd", "bwd")):
            side[site] = {"points_per_scene": pos.shape[1], "scenes": tables.shape[0],
                          "single_launches_ms": r[f"{d}_singles_ms"], **_fields(r, d)}
    operands.clear()
    return sites


def single_scene_rate(dev, name: str, args) -> dict:
    """SINGLE_SCENE_STEPS train steps of the campaign's first scene alone,
    the campaign's config: rays/s beside the campaign's all-scenes rate."""
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import render_scene
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.scripts import multi_scene_campaign as campaign

    cfg_scene = campaign.scene_configs(args)[0]
    data = dataset_from_scene(render_scene(cfg_scene, device=dev), dev, train_fraction=1.0)
    config = campaign.campaign_config(args, data.cameras.num_cameras)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    state = trainer.init_train_state(config, data.cameras.num_cameras, dev, generator=gen)
    for _ in range(3):
        trainer.train_step(state, data, config, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SINGLE_SCENE_STEPS):
        m = trainer.train_step(state, data, config, gen)
    m["total_loss"].item()
    dt = time.perf_counter() - t0
    rate = SINGLE_SCENE_STEPS * config.train_rays_per_batch / dt
    print(f"scale-out: one scene alone, {SINGLE_SCENE_STEPS} steps: {dt / SINGLE_SCENE_STEPS * 1e3:.3f}"
          f" ms a step, {rate:.1f} rays/s on {name}")
    return {"ms_per_step": dt / SINGLE_SCENE_STEPS * 1e3, "rays_per_sec": rate}


# One data-parallel rank (run as ``python -c``): for each of the job's seeds,
# trains the job's config from it through train_loop on the card, once
# with the gradients averaged and once with the planted fault (rank 0's
# shard's gradient broadcast, rank 1's dropped), and saves each run's
# metrics, parameters after the first step and final parameters.
DP_RANK = """
import dataclasses, sys, torch
import torch.distributed as dist
from fruitnerf_tpu_torch.bridge import tree_leaves
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.parallel import mesh as M
job_path, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
job = torch.load(job_path, weights_only=False)
mesh = M.init_data_mesh("gloo", world, rank, init)
averaged = M.average_gradients

def rank0_only(params, mesh):
    leaves = tree_leaves(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in leaves])
    dist.broadcast(flat, src=0)
    at = 0
    for p in leaves:
        p.grad = flat[at : at + p.numel()].view(p.shape)
        at += p.numel()

try:
    data, runs = job["data"], []
    for seed in job["seeds"]:
        for fault in (False, True):
            M.average_gradients = rank0_only if fault else averaged
            cfg = dataclasses.replace(job["config"], seed=seed)
            metrics, first = [], []
            def cb(it, st, m):
                metrics.append({k: float(v) for k, v in m.items()})
                if not first:
                    first.extend(p.detach().clone() for p in tree_leaves(st.params))
            state = trainer.train_loop(
                cfg, data, generator=torch.Generator(device=data.images.device).manual_seed(seed),
                mesh=mesh, callbacks=[cb])
            runs.append({"seed": seed, "fault": fault, "metrics": metrics, "first": first,
                         "params": tree_leaves(state.params)})
    torch.save(runs, out)
finally:
    M.average_gradients = averaged
    M.close_data_mesh()
"""
DP_KEYS = ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "psnr")


def dp_reference(trainer, cfg, data, dev) -> dict:
    """One rank's DP_STEPS steps of ``train_loop`` from ``cfg.seed``: the
    metrics, and the parameters and gradients after the first step."""
    from fruitnerf_tpu_torch.bridge import tree_leaves

    metrics, first, grads = [], [], []

    def cb(it, st, m):
        metrics.append({k: float(v) for k, v in m.items()})
        if not first:
            for p in tree_leaves(st.params):
                first.append(p.detach().clone())
                grads.append(torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())

    trainer.train_loop(cfg, data, generator=torch.Generator(device=dev).manual_seed(cfg.seed),
                       callbacks=[cb])
    return {"metrics": metrics, "first": first, "grads": grads}


def dp_compare(ref: dict, run: dict) -> dict:
    """A 2-rank run against the 1-rank one: the largest relative loss
    difference a step, and after the first step the parameters more than
    DP_PARAM_ATOL apart: how many, the largest one-rank |g| among them
    relative to its leaf's largest, the largest difference."""
    rels = [max(abs(m[k] - r[k]) / abs(r[k]) for k in DP_KEYS)
            for m, r in zip(run["metrics"], ref["metrics"])]
    apart = numel = 0
    rel_g = diff = 0.0
    for a, b, g in zip(ref["first"], run["first"], ref["grads"]):
        d = (a - b.to(a.device)).abs()
        far = d > DP_PARAM_ATOL
        apart += int(far.sum())
        numel += d.numel()
        diff = max(diff, float(d.max()))
        if far.any():
            rel_g = max(rel_g, float(g.abs()[far].max() / g.abs().max().clamp_min(1e-30)))
    return {"rels": rels, "apart": apart, "apart_share": apart / numel,
            "apart_max_rel_g": rel_g, "first_step_max_diff": diff}


def dp_check(dev, scene, name: str) -> dict:
    """Two gloo ranks sharing the card against one rank: the ``fruit_nerf``
    grid preset at full width, DP_RAYS rays (half a rank), DP_STEPS steps
    of ``train_loop`` from each of DP_SEEDS. The first step's losses within
    DP_FIRST_RTOL, the parameters after it apart only where the one-rank
    gradient is rounding noise (DP_FLIP_REL_G, 2 * DP_MAX_LR), every
    step's losses within DP_DRIFT_RTOL, the ranks bitwise equal; the
    planted fault breaks them. Then one step on an NCCL group of one rank,
    bitwise equal to the step without a mesh."""
    import socket

    from fruitnerf_tpu_torch.bridge import tree_leaves, tree_map
    from fruitnerf_tpu_torch.configs import apply_overrides, fruit_nerf
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine import trainer
    from fruitnerf_tpu_torch.parallel import mesh as M

    data = dataset_from_scene(scene, dev)
    cfg = apply_overrides(fruit_nerf(data.cameras.num_cameras),
                          {"train_rays_per_batch": DP_RAYS, "sparsity_loss": 0.005})
    cfg = dataclasses.replace(cfg, max_iters=DP_STEPS, steps_per_eval=0, steps_per_save=0)
    seeds = [cfg.seed + s for s in DP_SEEDS]
    refs = {s: dp_reference(trainer, dataclasses.replace(cfg, seed=s), data, dev) for s in seeds}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save({"config": cfg, "data": data, "seeds": seeds}, tmp / "job.pt")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP_RANK, str(tmp / "job.pt"), str(r), "2",
             f"file://{tmp / 'pg'}", str(tmp / f"rank{r}.pt")],
            cwd=Path(__file__).resolve().parent,  # the checkout: the port's package
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, e in zip(procs, errs):
            check(p.returncode == 0, f"a data-parallel rank failed:\n{e[-3000:]}")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ranks_s = time.perf_counter() - t0
    out = {"seeds": seeds, "averaged": [], "fault": []}
    for run0, run1 in zip(*ranks):
        same = run0["metrics"] == run1["metrics"] and all(
            torch.equal(a, b) for a, b in zip(run0["params"], run1["params"]))
        c = dp_compare(refs[run0["seed"]], run0)
        c.update(ranks_bitwise=same, steps=len(run0["metrics"]))
        c["passes"] = (c["rels"][0] <= DP_FIRST_RTOL and max(c["rels"]) <= DP_DRIFT_RTOL
                       and c["apart_max_rel_g"] <= DP_FLIP_REL_G
                       and c["first_step_max_diff"] <= 2 * DP_MAX_LR)
        out["fault" if run0["fault"] else "averaged"].append(c)
        print(f"scale-out: data parallel, seed {run0['seed']}, "
              f"{'planted fault (rank 1 dropped)' if run0['fault'] else 'averaged'}: 2 gloo "
              f"ranks on {name} against 1, {DP_STEPS} steps of {DP_RAYS} rays: losses' max rel "
              f"diff a step {[float(f'{x:.3e}') for x in c['rels']]}; after the first step "
              f"{c['apart']} parameters ({c['apart_share']:.3e}) more than {DP_PARAM_ATOL:g} "
              f"apart, their one-rank |g| at most {c['apart_max_rel_g']:.3e} of their leaf's max"
              f" (tol {DP_FLIP_REL_G:g}), at most {c['first_step_max_diff']:.3e} apart (tol "
              f"{2 * DP_MAX_LR:g}); ranks bitwise equal {same}; the checks pass: {c['passes']}")
    print(f"scale-out: data parallel: the ranks' runs {ranks_s:.1f} s with start-up; tol "
          f"{DP_FIRST_RTOL:g} at the first step, {DP_DRIFT_RTOL:g} after")
    for c in out["averaged"]:
        check(c["steps"] == DP_STEPS, "a data-parallel run stopped early")
        check(c["rels"][0] <= DP_FIRST_RTOL, f"2 ranks' first losses {c['rels'][0]:.3e} apart")
        check(c["apart_max_rel_g"] <= DP_FLIP_REL_G and c["first_step_max_diff"] <= 2 * DP_MAX_LR,
              "after the first step, 2 ranks' parameters part where the gradient is no noise")
        check(max(c["rels"]) <= DP_DRIFT_RTOL, f"2 ranks' losses {max(c['rels']):.3e} apart")
        check(c["ranks_bitwise"], "the two ranks differ")
    check(not any(c["passes"] for c in out["fault"]), "the checks pass a planted fault")

    # NCCL, one rank: the meshed step equals the plain one, bitwise
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mesh = M.init_data_mesh("nccl", 1, 0, f"tcp://localhost:{port}")
    try:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        a = trainer.init_train_state(cfg, data.cameras.num_cameras, dev, generator=gen)
        b = trainer.init_train_state(cfg, data.cameras.num_cameras, dev,
                                     params=tree_map(a.params, lambda t: t.detach().clone()))
        draws = trainer.draw_step(cfg, data, gen)
        ma = trainer.train_step(a, data, cfg, draws=draws, mesh=mesh)
        mb = trainer.train_step(b, data, cfg, draws=draws)
        torch.cuda.synchronize()
        nccl_same = all(torch.equal(ma[k], mb[k]) for k in mb) and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    finally:
        M.close_data_mesh()
    print(f"scale-out: one NCCL rank: the meshed step bitwise equal to the plain one: {nccl_same}")
    check(nccl_same, "the NCCL world-1 step differs from the step without a mesh")
    out["nccl_world1_bitwise"] = nccl_same
    return out


def mesh_check(dev, hg, name: str, root: Path) -> dict:
    """``--mesh``: a short grid run through ``train``, then render and export
    with devices=[card, card] against the unsharded result, and ``eval``,
    ``render``, ``export`` and the viewer with ``--mesh`` (a one-card mesh
    here) against the commands without it."""
    from fruitnerf_tpu_torch.data.builder import cameras_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine.runs import load_run
    from fruitnerf_tpu_torch.engine.trainer import render_camera
    from fruitnerf_tpu_torch.export.ply import read_ply
    from fruitnerf_tpu_torch.export.volume_sampler import ExportConfig, sample_volume
    from fruitnerf_tpu_torch.scripts import evaluate, export, render, train
    from fruitnerf_tpu_torch.viewer.server import ViewerSession

    run = root / "mesh_run"
    run_cli(train, ["--data", "synthetic", "--max-iters", str(MESH_ITERS), "--output-dir",
                    str(run), "--sparsity-loss", "0.005"])
    manifest, config, state = load_run(run, dev)
    cams = cameras_from_scene(render_scene(SyntheticSceneConfig(num_cameras=24, image_size=128),
                                           device=dev), dev)
    two = [dev, dev]
    one_r = render_camera(state.params, cams, 3, config)
    two_r = render_camera(state.params, cams, 3, config, devices=two)
    render_diff = max((one_r[k] - two_r[k]).abs().max().item() for k in one_r)
    exp = ExportConfig(num_points_per_side=64, semantic_logit_threshold=-1e9,
                       density_threshold=-1.0, colormap_prob_threshold=0.0)
    clouds = [sample_volume(state.params["model"], config.model, exp, 1.0, root / f"x{i}",
                            progress=False, devices=d) for i, d in enumerate((None, two))]

    def srt(c):
        o = np.lexsort(c["points"].T[::-1])
        return c["points"][o], c["colors"][o]

    (pa, ca), (pb, cb) = srt(clouds[0]["density"]), srt(clouds[1]["density"])
    export_same = pa.shape == pb.shape and bool((pa == pb).all())
    color_diff = float(np.abs(ca - cb).max()) if export_same else float("inf")
    outs = {}
    for flag in ([], ["--mesh"]):
        tag = "mesh" if flag else "plain"
        outs[f"eval_{tag}"] = run_cli(evaluate, ["--load-dir", str(run), "--data", "synthetic",
                                                 *flag])
        run_cli(render, ["--load-dir", str(run), "--data", "synthetic", "--output-dir",
                         str(root / f"r_{tag}"), "--cameras", "0", "3", *flag])
        run_cli(export, ["--load-dir", str(run), "--output-dir", str(root / f"e_{tag}"),
                         "--num-points-per-side", "96", *flag])
    timing = ("num_rays_per_sec", "fps")
    eval_same = {k: v for k, v in outs["eval_plain"].items() if k not in timing} == \
        {k: v for k, v in outs["eval_mesh"].items() if k not in timing}
    from PIL import Image

    render_same = all(
        np.array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(root / "r_mesh" / p.name)))
        for p in sorted((root / "r_plain").glob("*.png")))
    ply_same = all(np.array_equal(read_ply(root / "e_plain" / f"{n}.ply")["points"],
                                  read_ply(root / "e_mesh" / f"{n}.ply")["points"])
                   for n in ("semantic", "semantic_colormap", "density"))
    views = [ViewerSession.from_run_dir(run, dev, d) for d in (None, [dev])]
    view_same = np.array_equal(*(v.render_frame(0.8, 0.5, 2.5, 128, "rgb") for v in views))
    print(f"scale-out: --mesh on {name}: render on [card, card] max abs diff {render_diff:.3e} "
          f"(tol {RENDER_MESH_ATOL:g}); export on [card, card] {pa.shape[0]} points, the same "
          f"set {export_same}, colours max diff {color_diff:.3e}; eval --mesh as eval "
          f"{eval_same}, render --mesh PNGs equal {render_same}, export --mesh clouds equal "
          f"{ply_same}, viewer --mesh frame equal {view_same}")
    check(render_diff <= RENDER_MESH_ATOL, "the two-shard render differs")
    check(export_same and color_diff <= RENDER_MESH_ATOL, "the two-shard export differs")
    check(eval_same and render_same and ply_same and view_same,
          "a --mesh command differs from the command without it")
    return {"render_max_abs_diff": render_diff, "export_points": int(pa.shape[0])}


def scaleout_phase(dev, hg, name: str, seed: int, scene) -> dict:
    """The scene-batched kernels, the grid and parity campaigns (batched
    K1/K2 and K3/K4 on their paths), one scene alone timed beside the
    campaign, data parallelism and --mesh. -> {"kernels": the batched
    kernels' entries, with their launches; the rest's numbers}."""
    t_start = time.perf_counter()
    entries = scene_kernels(hg, dev, seed)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        grid = campaign_run(hg, name, GRID_CAMPAIGN, CAMPAIGN_ITERS, root / "grid")
        from fruitnerf_tpu_torch.scripts import multi_scene_campaign as campaign

        grid_args = argparse.Namespace(**grid["report"]["args"])
        cfg = campaign.campaign_config(grid_args, grid_args.num_cameras)
        want = predicted_cell_launches(cfg, CAMPAIGN_ITERS, 0)
        got = grid["counts"]["launches"]
        print(f"scale-out: the grid campaign's steps launched {got}; one scene's steps would "
              f"launch {want}; scenes {grid['counts']['scenes']}")
        check(got == want, "the grid campaign's K1/K2 launches are not one a call for all scenes")
        check(all(grid["counts"]["scenes"][k] == SCENES * got[k] for k in got),
              "a grid campaign launch did not take every scene")
        check(len(grid["operands"]) == 2, "the grid campaign's last step: not 2 batched K2 calls")
        grid_sites = campaign_kernels(hg, "grid campaign", grid["operands"])
        single = single_scene_rate(dev, name, grid_args)
        parity = campaign_run(hg, name, PARITY_CAMPAIGN, CAMPAIGN_PARITY_ITERS,
                              root / "parity")
        parity_args = argparse.Namespace(**parity["report"]["args"])
        pcfg = campaign.campaign_config(parity_args, parity_args.num_cameras)
        pwant = predicted_hash_launches(pcfg, range(CAMPAIGN_PARITY_ITERS), 0, 0)
        pgot = parity["counts"]["launches"]
        print(f"scale-out: the parity campaign's steps launched {pgot}, predicted {pwant}")
        check(pgot == pwant, "the parity campaign's K3/K4 launches differ from one a call")
        check(all(parity["counts"]["scenes"][k] == SCENES * pgot[k] for k in pgot),
              "a parity campaign launch did not take every scene")
        last = predicted_hash_launches(
            pcfg, range(CAMPAIGN_PARITY_ITERS - 1, CAMPAIGN_PARITY_ITERS), 0, 0)
        check(len(parity["operands"]) == last["corner_encode_bwd"],
              "the parity campaign's last step: not its predicted batched K4 calls")
        parity_sites = campaign_kernels(hg, "parity campaign", parity["operands"])
        out["dp"] = dp_check(dev, scene, name)
        out["mesh"] = mesh_check(dev, hg, name, root)
    for e in entries:
        base = e["name"].removesuffix("_scenes")
        e["launches"] = got[base] + pgot[base]
        sites = grid_sites if base.startswith("cell") else parity_sites
        e["campaign_step"] = sites[base.endswith("_bwd")]
        e["max_abs_err"] = max(e["max_abs_err"],
                               *(r["max_abs_err"] for r in e["campaign_step"].values()))
    out.update(kernels=entries, campaign={k: grid["report"][k] for k in (
        "train_s", "train_rays_per_sec_all_scenes", "final_loss_per_scene",
        "final_psnr_per_scene", "scenes")}, single_scene=single,
        parity_campaign_train_s=parity["report"]["train_s"],
        seconds=time.perf_counter() - t_start)
    print(f"scale-out: every check passed in {out['seconds']:.3f} s")
    return out


def _other_kernels(lib, hg, corner: bool):
    """Wrappers of another build's cell_encode or corner_encode pair (of
    this checkout's C interface), uncounted: -> (fwd(table, pos, layout,
    f), bwd(table, pos, grad, layout, f)); cell mode has f = 2. The forward
    takes one scene; the backward one, or S of contiguous [S, ...] tables,
    positions and gradients in one launch."""
    kind = "corner" if corner else "cell"
    sizer = getattr(lib, f"{kind}_encode_bwd_work_bytes")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(table, pos, layout, f):
        out = torch.empty((pos.shape[0], f * layout.num_levels), device=pos.device)
        head = (pos.data_ptr(), table.data_ptr(), out.data_ptr(), pos.shape[0], 1, 0, 0)
        levels = (layout.num_levels, *hg._level_arrays(layout), stream())
        err = (lib.corner_encode_fwd(*head, f, *levels) if corner
               else lib.cell_encode_fwd(*head, *levels))
        check(err == 0, f"the other {kind}_encode_fwd: CUDA error {err}")
        return out

    def bwd(table, pos, grad, layout, f):
        dtable, dpos = torch.empty_like(table), torch.empty_like(pos)
        scenes = pos.shape[0] if pos.dim() == 3 else 1
        strides = (pos[0].numel(), table[0].numel()) if pos.dim() == 3 else (0, 0)
        nbytes = (sizer(layout.total_rows, f, layout.num_levels, scenes) if corner
                  else sizer(layout.total_rows, layout.num_levels, scenes))
        work = torch.empty(nbytes, dtype=torch.uint8, device=pos.device)
        head = (pos.data_ptr(), table.data_ptr(), grad.data_ptr(), dtable.data_ptr(),
                dpos.data_ptr(), work.data_ptr(), pos.shape[-2], scenes, *strides)
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


AB_STEPS = 50  # steps of a preset before its last step's grid operands are captured


def preset_step_cases(name: str, scene, dev, seed: int) -> dict:
    """The positions of the K2/K4 launches of one train step of a preset of
    ``step_bench`` (``big``, ``parity`` or ``huge``) on the slices' scene,
    after AB_STEPS steps (recorded by ``scene_operands``), each with a
    random table and output gradient: -> {label: (layout, F, table,
    positions, grad)}, labelled by their order in the step, layout and
    point count."""
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, train_step
    from fruitnerf_tpu_torch.ops import hash_grid as hg
    from fruitnerf_tpu_torch.scripts.step_bench import configs

    data = dataset_from_scene(scene, dev)
    cfg = configs(data.cameras.num_cameras)[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, data.cameras.num_cameras, dev, generator=gen)
    for _ in range(AB_STEPS - 1):
        train_step(state, data, cfg, gen)
    calls = []
    with scene_operands(hg, calls, batched=False):
        train_step(state, data, cfg, gen)
    torch.cuda.synchronize(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    cases = {}
    for i, (_, table, pos, grad, layout, f) in enumerate(calls):
        label = (f"{name}_call{i}_{layout.num_levels}x{layout.rows[-1]}_res"
                 f"{layout.resolutions[-1]}_p{pos.shape[0]}")
        cases[label] = (layout, f, torch.rand(table.shape, generator=g, device=dev) * 2 - 1,
                        pos, torch.randn(grad.shape, generator=g, device=dev))
    return cases


def cell_ab_cases(layout, captured: list, dev, seed: int, scene=None) -> dict:
    """K1/K2's A/B inputs: uniform-random points, the cell step's fine and
    sparsity points, (K1 alone) an export batch and, with ``scene``, the
    big preset's step positions at its layout."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, nl = layout.total_rows, layout.num_levels
    cases = {"random": (layout, 2, *_inputs(dev, g, rows, 16, 2 * nl))}
    for name, pos in zip(("step_fine", "step_sparsity"), captured):
        cases[name] = (layout, 2, *_inputs(dev, g, rows, 16, 2 * nl, pos=pos))
    export_pos, _ = export_batch(dev)
    table = torch.rand((rows, 16), generator=g, device=dev) * 2.0 - 1.0
    cases["export"] = (layout, 2, table, export_pos, None)
    if scene is not None:
        cases.update(preset_step_cases("big", scene, dev, seed))
    return cases


def corner_ab_cases(hg, grid, captured: list, dev, seed: int, scene=None) -> dict:
    """K3/K4's A/B inputs: uniform-random points and the corner step's fine
    and sparsity points, at the corner slice's layout (F = 2) and at the
    kernel phase's F = 4 layout; with ``scene``, the parity and huge (parity)
    presets' step positions at their hash layouts."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    cases = {}
    for layout, f in ((grid.table_layout(), grid.features_per_level),
                      (hg.corner_layout(*CORNER_F4), 4)):
        rows, width = layout.total_rows, f * layout.num_levels
        cases[f"random_f{f}"] = (layout, f, *_inputs(dev, g, rows, f, width))
        for name, pos in zip(("step_fine", "step_sparsity"), captured):
            cases[f"{name}_f{f}"] = (layout, f, *_inputs(dev, g, rows, f, width, pos=pos))
    if scene is not None:
        for name in ("parity", "huge"):
            cases.update(preset_step_cases(name, scene, dev, seed))
    return cases


def ab_phase(hg, old_source: Path, corner: bool, cases: dict) -> dict:
    """A kernel pair of this checkout ("new") against another build of the
    same source ("old", built apart) and the plain version, in turns plain,
    old, new, new, old, plain, on each case (name -> (layout, F, table,
    positions, output gradient, or None to time the forward alone)). Each
    is held to the plain version first; each case also carries its bounds,
    the ``embedding_bag`` yardstick's times and, for a backward, both
    sides' passes and one launch's dTable adds."""
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
            if d == "bwd":  # both backwards' passes, and the adds of one launch
                row[d]["passes"] = {side: pass_split(sides[side]) for side in ("old", "new")}
                row[d].update(hg.backward_adds(pos, layout, f, corner))
                split = {side: {k: round(v, 4) for k, v in p.items()}
                         for side, p in row[d]["passes"].items()}
                print(f"ab: {name} bwd passes (ms a launch) {split}; runs {row[d]['runs']}, "
                      f"adds {row[d]['adds']}, modeled L2 lines {row[d]['modeled_l2_lines']}")
        results[name] = row
    return results


def ab_scenes(hg, old_source: Path, corner: bool, dev, seed: int) -> dict:
    """The scene-batched backward of this checkout ("new") against another
    build's ("old") at scale_out's shapes: SCENES scenes of P_SLICE random
    points in one launch, K2 at the fruit_nerf two-tier layout or K4 at the
    parity main field, in turns old, new, new, old (medians of 10); each
    scene of both held to the plain version, with the new one's passes and
    adds and the bound of SCENES single launches."""
    from fruitnerf_tpu_torch.configs import fruit_nerf
    lib, _ = hg.build_library([old_source], Path(hg._BUILD) / "ab")
    _, old_bwd = _other_kernels(lib, hg, corner)
    plain, _, new_bwd = _this_kernels(hg, corner)
    if corner:
        main = fruit_nerf(1, variant="parity").model.field.hash
        layout, f, width = hg.corner_layout(main.level_resolutions(), main.table_size), 2, 2
    else:
        layout, f, width = fruit_nerf(1).model.field.grid.cell_layout(), 2, 16
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    tables = torch.rand((SCENES, layout.total_rows, width), generator=g, device=dev) * 2 - 1
    pos = torch.rand((SCENES, P_SLICE, 3), generator=g, device=dev) * 0.98 + 0.01
    grad = torch.randn((SCENES, P_SLICE, f * layout.num_levels), generator=g, device=dev)
    sides = {"old": lambda: old_bwd(tables, pos, grad, layout, f),
             "new": lambda: new_bwd(tables, pos, grad, layout, f)}
    got = {side: fn() for side, fn in sides.items()}
    err = {"old": 0.0, "new": 0.0}
    for sc in range(SCENES):
        t_ = tables[sc].clone().requires_grad_(True)
        p_ = pos[sc].clone().requires_grad_(True)
        dt_p, dp_p = torch.autograd.grad(plain(t_, p_, layout, f), (t_, p_), grad[sc])
        for side, (dt, dp) in got.items():
            err[side] = max(err[side], ((dt[sc] - dt_p).abs().max() / dt_p.abs().max()).item(),
                            ((dp[sc] - dp_p).abs().max() / dp_p.abs().max()).item())
    check(max(err.values()) <= BWD_RTOL, f"ab scenes: backward errors {err}")
    times = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        times[side].append(median_ms(sides[side], iters=10))
    costs = [work(hg, pos[sc], layout, f, corner)["bwd"] for sc in range(SCENES)]
    b = bound(sum(c["bytes"] for c in costs), sum(c["ops"] for c in costs))
    counts = collections.Counter()
    for sc in range(SCENES):
        counts.update(hg.backward_adds(pos[sc], layout, f, corner))
    row = {"scenes": SCENES, "points_per_scene": P_SLICE, "errors": err, **times,
           "bound": b["bound_ms"], "bound_by": b["bound_by"],
           "passes": {side: pass_split(fn) for side, fn in sides.items()},
           **counts}
    print(f"ab: {'K4' if corner else 'K2'} x {SCENES} scenes ({layout.num_levels} levels, "
          f"{layout.total_rows} rows, P {P_SLICE} a scene) bwd ms (median of 10) old "
          f"{times['old']} new {times['new']}; bound {b['bound_ms']:.4f}; errors {err}; "
          f"passes {row['passes']}; runs {counts['runs']}, adds {counts['adds']}, modeled L2 "
          f"lines {counts['modeled_l2_lines']}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="steps of each slice (400 until the orchard phase counted)")
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
    t_start = time.perf_counter()
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
                                  cell_ab_cases(cell_layout, captured, dev, args.seed, scene))
            ab["cell"]["scenes"] = ab_scenes(hg, args.ab_cell_source, False, dev, args.seed)
        if args.ab_corner_source is not None:
            _, captured = corner_slice_phase(scene, dev, args.steps, args.seed, hg, name)
            ab["corner"] = ab_phase(hg, args.ab_corner_source, True,
                                    corner_ab_cases(hg, corner_grid, captured, dev, args.seed,
                                                    scene))
            ab["corner"]["scenes"] = ab_scenes(hg, args.ab_corner_source, True, dev, args.seed)
        print(json.dumps({"ab": ab}))
        print(card)
        return 0

    seconds = {}

    def timed(label, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    kernels = timed("kernels", kernel_phase, hg, cell_layout, corner_grid, dev, args.seed)
    timed("parity", parity_phase, scene, dev, args.seed)
    cell_counts, captured = timed("slice", slice_phase, scene, dev, args.steps, args.seed, hg,
                                  name)
    step12 = step_layout(lambda t, p, gr, label: cell_pair(hg, cell_layout, label, t, p, gr),
                         cell_layout, 16, 2 * cell_layout.num_levels, captured, dev, args.seed,
                         "K1/K2")
    corner_counts, captured = timed("corner", corner_slice_phase, scene, dev, args.steps,
                                    args.seed, hg, name)
    corner_layout, f = corner_grid.table_layout(), corner_grid.features_per_level
    step34 = step_layout(
        lambda t, p, gr, label: corner_pair(hg, corner_layout, f, label, t, p, gr),
        corner_layout, f, f * corner_layout.num_levels, captured, dev, args.seed, "K3/K4")
    orchard_counts = timed("orchard", orchard_phase, dev, ORCHARD_ITERS, COUNT_EXPORT_N, hg,
                           name)
    parity_cfg = parity_config(ORCHARD["num_cameras"], PARITY_ITERS)
    hash_random = timed("hash", hash_kernel_phase, hg, parity_cfg, dev, args.seed)
    captured = collections.deque(maxlen=4)  # the last parity step's four encodings
    parity_counts = timed("orchard parity", orchard_phase, dev, PARITY_ITERS, EXPORT_N, hg,
                          name, "parity", captured)
    hash_step = hash_step_layouts(hg, parity_cfg, list(captured), dev, args.seed)
    smoke_counts = timed("smoke", smoke_phase, dev, hg, name, args.seed)
    disk_counts = timed("disk", disk_phase, dev, hg, name, args.seed)
    presets = timed("presets", presets_phase, dev, hg, name, args.seed)
    for k in kernels:  # K5/K6's launches were counted on their own path, in the kernel phase
        if k["name"].startswith("corner_encode"):
            k["launches"] = corner_counts[k["name"]] + parity_counts[k["name"]] \
                + smoke_counts[k["name"]] + presets["huge"][k["name"]] \
                + presets["tools"]["launches"][k["name"]]
        elif k["name"].startswith("cell_encode"):
            k["launches"] = cell_counts[k["name"]] + orchard_counts[k["name"]] \
                + disk_counts[k["name"]] + presets["big"][k["name"]] \
                + presets["tools"]["launches"][k["name"]]
    # K1/K2 and K3/K4 at their step's positions; K3/K4 at the parity and
    # huge layouts, K1/K2 at the big layout
    for pair, key, step in ((kernels[0:2], "step", step12), (kernels[2:4], "step", step34),
                            (kernels[2:4], "parity_random", hash_random),
                            (kernels[2:4], "parity_step", hash_step),
                            (kernels[0:2], "big_step", presets["big_step"]),
                            (kernels[2:4], "huge_step", presets["huge_step"])):
        for k, d in zip(pair, ("fwd", "bwd")):
            k[key] = {at: {"points": r["points"], **_fields(r, d)} for at, r in step.items()}
            k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in k[key].values()))
    scaleout = timed("scale-out", scaleout_phase, dev, hg, name, args.seed, scene)
    kernels += scaleout["kernels"]  # the scene-batched launches of K1-K4
    timed("passes", passes_phase, kernels)
    check("jax" not in sys.modules, "the port imported jax")
    jax_package = sorted(m for m in sys.modules
                         if m == "fruitnerf_tpu" or m.startswith("fruitnerf_tpu."))
    check(not jax_package, f"the port imported the JAX package: {jax_package}")

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s; "
          f"seconds a phase {seconds}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
