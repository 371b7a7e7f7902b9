#!/usr/bin/env python3
"""Drive the PyTorch port once on an NVIDIA GPU: build the CUDA kernels from
this checkout, hold each against its plain PyTorch version, train the
full-width ``fruit_nerf`` grid preset (cell mode, by hand) and its corner-mode
grid (through ``train_loop``, with evals and checkpoints) for a few hundred
steps each on a synthetic scene, and resume and render.

    python3 chip_smoke.py [--steps 400] [--seed 0]

Phases, each printing its lines:
  card     nvidia-smi's name and power limit; TF32 switched off for matmuls
           and cuDNN
  build    nvcc of fruitnerf_tpu_torch/csrc into fruitnerf_tpu_torch/_build;
           registers of each kernel
  kernels  at P = 4096*48 + 4096 points, each kernel pair against its plain
           version: max errors and median times. K1/K2 (cell_encode.cu) at
           the cell slice's layout; K3/K4 (corner_encode.cu) at the corner
           slice's (16 levels, T = 8192, F = 2) and at a small F = 4 layout;
           K5/K6 (cell v1, the cell kernels at a uniform 16-level T = 8192
           layout) through grid_encode_flat(mode="cell") and its autograd,
           after one counted forward and backward through that entry (cell
           v1's only path: no training path reaches it)
  parity   one small train step's losses and colour-MLP gradient on the GPU
           (kernels) against the CPU (plain version), same parameters and draws
  slice    the cell-mode training steps: finite losses, PSNR rising, every
           step through K1 and K2; steps/s and rays/s; a held-out render
  corner   train_loop on the corner-mode grid, logging every step and
           evaluating and checkpointing every 100: finite losses, PSNR
           rising, every step through K3 and K4, finite eval stats with SSIM
           in [-1, 1]; steps/s and rays/s (the per-step log syncs the host
           each step; the cell slice does not). Then the manifest, whose grid entry
           must rebuild the layout, and a resume into a fresh state that must
           equal the trained one and render the held-out camera identically
Then one JSON line of the six kernels, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
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


def hold_pair(label, fwd, bwd, plain, table, pos, grad) -> dict:
    """A forward kernel ``fwd(table, pos)`` and its backward ``bwd(table,
    pos, grad) -> (dTable, dPos)`` against the plain version's forward and
    autograd backward, on the same inputs: errors (checked) and median
    times of each. With ``bwd=None`` the backward is taken through
    autograd of ``fwd``, as a training step takes it."""
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
    }
    print(f"kernels: {label} forward {times['fwd_ms']:.4f} ms, plain "
          f"{times['fwd_plain_ms']:.4f} ms; backward {times['bwd_ms']:.4f} ms, plain "
          f"{times['bwd_plain_ms']:.4f} ms (median)")
    return {"fwd_err": fwd_err, "bwd_err": max(dt_err, dp_err), **times}


def _entries(r: dict, names, src: str, functions, lines, launches=(0, 0)) -> list[dict]:
    """The kernels-JSON entries of a forward/backward pair (launches of the
    training paths are filled in after their runs)."""
    return [
        {"name": name, "route": "cuda", "source": src, "function": fn,
         "replaces": f"{TPU}:{line}", "launches": n, "max_abs_err": r[f"{d}_err"],
         "ms": r[f"{d}_ms"], "plain_ms": r[f"{d}_plain_ms"]}
        for d, name, fn, line, n in zip(("fwd", "bwd"), names, functions, lines, launches)
    ]


def _inputs(dev, g, rows, width, out_dim):
    table = torch.rand((rows, width), generator=g, device=dev) * 2.0 - 1.0
    pos = torch.rand((P_SLICE, 3), generator=g, device=dev) * 0.98 + 0.01
    grad = torch.randn((P_SLICE, out_dim), generator=g, device=dev)
    return table, pos, grad


def kernel_phase(hg, cell_layout, corner_grid, dev, seed: int) -> list[dict]:
    """Every kernel at the shapes its path gives it, against its plain
    version: K1/K2 at the cell slice's layout, K3/K4 at the corner slice's
    (and once at F = 4), K5/K6 (cell v1, served by the cell kernels at a
    uniform layout) through ``grid_encode_flat(mode="cell")``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    print(f"kernels: P={P_SLICE}")

    k12 = hold_pair(
        f"K1/K2 cell v2 ({cell_layout.num_levels} levels, {cell_layout.total_rows} rows)",
        lambda t, p: hg.cell_encode_fwd_cuda(t, p, cell_layout),
        lambda t, p, gr: hg.cell_encode_bwd_cuda(t, p, gr, cell_layout, True),
        lambda t, p: hg.cell_encode_torch(t, p, cell_layout),
        *_inputs(dev, g, cell_layout.total_rows, 16, 2 * cell_layout.num_levels),
    )

    def corner(layout, feats, label):
        return hold_pair(
            label,
            lambda t, p: hg.corner_encode_fwd_cuda(t, p, layout, feats),
            lambda t, p, gr: hg.corner_encode_bwd_cuda(t, p, gr, layout, feats, True),
            lambda t, p: hg.grid_encode_corner_torch(t, p, layout, feats),
            *_inputs(dev, g, layout.total_rows, feats, feats * layout.num_levels),
        )

    f = corner_grid.features_per_level
    layout = corner_grid.table_layout()
    k34 = corner(layout, f, f"K3/K4 corner ({layout.num_levels} levels, T={layout.rows[0]}, "
                            f"F={f}, direct {sum(layout.direct)})")
    small = hg.corner_layout((8, 64, 1024, 2048), 4096)
    corner(small, 4, "K3/K4 corner (4 levels, T=4096, F=4)")

    res, t_v1 = corner_grid.level_resolutions(), corner_grid.table_size
    v1 = hg.uniform_cell_layout(res, t_v1)

    def flat(t, p):
        return hg.grid_encode_flat(t, p, res, t_v1, 2, "cell")

    table, pos, grad = _inputs(dev, g, v1.total_rows, 16, 2 * len(res))
    v1_counts = flat_path_launches(hg, flat, table, pos, grad)
    k56 = hold_pair(
        f"K5/K6 cell v1 ({len(res)} levels, T={t_v1}, direct {sum(v1.direct)})",
        flat, None, lambda t, p: hg.cell_encode_torch(t, p, v1), table, pos, grad,
    )
    cell_fns = ("cell_encode_fwd_kernel", "cell_encode_bwd_kernel")
    return (
        _entries(k12, ("cell_encode_fwd", "cell_encode_bwd"), CELL_SRC, cell_fns, (523, 581))
        + _entries(k34, ("corner_encode_fwd", "corner_encode_bwd"), CORNER_SRC,
                   ("corner_encode_fwd_kernel", "corner_encode_bwd_kernel"), (163, 203))
        + _entries(k56, ("cell_v1_encode_fwd", "cell_v1_encode_bwd"), CELL_SRC, cell_fns,
                   (865, 903), (v1_counts["cell_encode_fwd"], v1_counts["cell_encode_bwd"]))
    )


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


def slice_phase(scene, dev, steps: int, seed: int, hg, name: str):
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
    return dict(hg.LAUNCHES)


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
    fresh state that must equal the trained one."""
    from fruitnerf_tpu.utils.writer import MetricWriter
    from fruitnerf_tpu_torch.bridge import tree_leaves
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine import checkpoints as ck
    from fruitnerf_tpu_torch.engine.trainer import init_train_state, render_camera, train_loop

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
        hg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_loop(cfg, data, eval_indices=held, generator=gen, writer=writer,
                           checkpoint_dir=run / "checkpoints", timings=timings)
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
        rebuilt = ck.grid_from_manifest(manifest)  # raises if it rebuilds another layout
        check(rebuilt.table_layout() == grid.table_layout()
              and rebuilt.table_shape == grid.table_shape, "the manifest rebuilt another layout")
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
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400, help="steps of each slice")
    ap.add_argument("--seed", type=int, default=0)
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

    info = hg.build_kernels()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    print(f"build: {info.seconds:.2f} s -> {info.path.parent.name}; {len(regs)} kernels")
    for ln in regs:
        print(f"build: {ln}")

    kernels = kernel_phase(hg, fruit_nerf(1).model.field.grid.cell_layout(),
                           corner_config(1).model.field.grid, dev, args.seed)

    scene = render_scene(SyntheticSceneConfig(image_size=128, num_cameras=24, seed=args.seed))
    parity_phase(scene, dev, args.seed)
    cell_counts = slice_phase(scene, dev, args.steps, args.seed, hg, name)
    corner_counts = corner_slice_phase(scene, dev, args.steps, args.seed, hg, name)
    for k in kernels:  # K5/K6's launches were counted on their own path, in the kernel phase
        if k["name"].startswith("corner_encode"):
            k["launches"] = corner_counts[k["name"]]
        elif k["name"].startswith("cell_encode"):
            k["launches"] = cell_counts[k["name"]]
    check("jax" not in sys.modules, "the port imported jax")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
