"""Time, profile and repeat train steps of the presets on a synthetic scene.

    python -m fruitnerf_tpu_torch.scripts.step_bench
        [--config grid smoke parity big huge tpu] [--steps 30] [--profile 10]
        [--repeat] [--seed 0] [--json PATH]

The configurations: ``grid`` is the ``fruit_nerf`` preset's grid variant
(cell mode), ``smoke`` the smoke preset, ``parity`` the parity variant (the
reference's hash grid), ``big`` the ``fruit_nerf_big`` preset's grid
variant, ``huge`` the ``fruit_nerf_huge`` preset's parity variant and
``tpu`` the ``fruit_nerf`` preset's tpu variant (the frequency field, no
table); ``grid``, ``parity`` and ``big`` carry the sparsity prior (0.005),
as ``orchard-e2e`` and ``chip_smoke.py`` train them. Each trains on a
128^2, 24-camera synthetic scene at its full width. For each it prints and
returns:

* the mean wall milliseconds of ``--steps`` train steps after 5 of warmup,
  synchronised at both ends, and the process's CPU milliseconds a step over
  them (the host's own work, which other load on the host does not add to);
* with ``--profile N``: N steps under ``torch.profiler``, the device busy
  milliseconds a step (the kernels' self time), the device time a step of
  the grid encodings, the fills and adds of main-table-sized tensors, Adam
  and the matmuls, the top ops by input shape and the top kernels, and the
  peak device memory;
* with ``--repeat``: ``two_runs`` of REPEAT_STEPS steps, which must be
  bitwise equal (the script exits non-zero otherwise).

It runs on the card unless ``--device cpu`` asks for the CPU. To compare two
checkouts, run this file from each in turns (A, B, B, A), in one call.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPEAT_STEPS = 5


def configs(num_images: int) -> dict:
    """The configurations by name (see the module docstring)."""
    from ..configs import (
        apply_overrides,
        fruit_nerf,
        fruit_nerf_big,
        fruit_nerf_huge,
        fruit_nerf_smoke,
    )

    prior = {"sparsity_loss": 0.005}
    return {"grid": apply_overrides(fruit_nerf(num_images), prior),
            "smoke": fruit_nerf_smoke(num_images),
            "parity": apply_overrides(fruit_nerf(num_images, variant="parity"), prior),
            "big": apply_overrides(fruit_nerf_big(num_images), prior),
            "huge": fruit_nerf_huge(num_images, variant="parity"),
            "tpu": fruit_nerf(num_images, variant="tpu")}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_ms(cfg, data, seed: int, steps: int, warmup: int = 5) -> tuple[float, float]:
    """-> (wall, process CPU) milliseconds a step, means over ``steps`` train
    steps after ``warmup``, synchronised at both ends."""
    from ..engine.trainer import init_train_state, train_step

    dev = data.images.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, data.cameras.num_cameras, dev, generator=gen)
    for _ in range(warmup):
        train_step(state, data, cfg, gen)
    _sync(dev)
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(steps):
        train_step(state, data, cfg, gen)
    _sync(dev)
    return ((time.perf_counter() - t0) / steps * 1e3, (time.process_time() - c0) / steps * 1e3)


def two_runs(cfg, data, seed: int, steps: int = REPEAT_STEPS) -> dict:
    """``steps`` train steps, twice, from one seed and on the same draws:
    -> whether every loss and parameter is bitwise equal, the largest
    relative difference of a step's loss, and how many parameter tensors
    differ and by how much at most."""
    from ..bridge import tree_leaves
    from ..engine.trainer import draw_step, init_train_state, train_step

    dev, n = data.images.device, data.cameras.num_cameras
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    draws = [draw_step(cfg, data, gen) for _ in range(steps)]
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, n, dev, generator=torch.Generator(device=dev).manual_seed(seed))
        losses = torch.stack([train_step(state, data, cfg, draws=d)["total_loss"] for d in draws])
        runs.append((losses.double().cpu(), [t.detach().clone() for t in tree_leaves(state.params)]))
    (la, pa), (lb, pb) = runs
    loss_rel = ((la - lb).abs() / la.abs().clamp_min(1e-30)).max().item()
    differ = sum(not torch.equal(a, b) for a, b in zip(pa, pb))
    return {"bitwise": loss_rel == 0.0 and differ == 0, "loss_max_rel": loss_rel,
            "leaves_differ": differ, "leaves": len(pa),
            "param_max_abs": max((a - b).abs().max().item() for a, b in zip(pa, pb))}


def profile_steps(cfg, data, seed: int, steps: int) -> dict:
    """``steps`` train steps (after 5 of warmup) under ``torch.profiler`` on
    the card: device busy ms a step, device ms a step of a few op groups,
    the top ops (by input shape) and kernels, and the peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine.trainer import init_train_state, train_step

    dev = data.images.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, data.cameras.num_cameras, dev, generator=gen)
    for _ in range(5):
        train_step(state, data, cfg, gen)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            train_step(state, data, cfg, gen)
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    def dev_us(row):  # the attribute's name moved in torch 2.x
        us = getattr(row, "self_device_time_total", None)
        return row.self_cuda_time_total if us is None else us

    # device rows: kernels and memsets, not the ranges of record_function
    # annotations (the optimizer's "Optimizer.step#Adam.step"), which overlap them
    kernels = [r for r in prof.key_averages() if str(r.device_type).endswith("CUDA")
               and "#" not in r.key and not r.key.startswith("ProfilerStep")]
    busy = sum(dev_us(r) for r in kernels) / 1e3 / steps
    ops = [r for r in prof.key_averages(group_by_input_shape=True)
           if not str(r.device_type).endswith("CUDA")]
    enc = cfg.model.field.encoding_config
    table = "no table" if enc is None else str(list(enc.table_shape))

    def group(pred) -> dict:
        hit = [r for r in ops if pred(r.key, str(r.input_shapes))]
        return {"calls": sum(r.count for r in hit) / steps,
                "device_ms": sum(dev_us(r) for r in hit) / 1e3 / steps}

    groups = {
        "grid encoding forward (K1/K3)": group(
            lambda k, sh: k in ("_CellEncodeCUDA", "_CornerEncodeCUDA")),
        "grid encoding backward (K2/K4)": group(
            lambda k, sh: k in ("_CellEncodeCUDABackward", "_CornerEncodeCUDABackward")),
        "fills of a main-table-sized tensor": group(
            lambda k, sh: k in ("aten::fill_", "aten::zero_") and sh.startswith(f"[{table}")),
        "adds of two main-table-sized tensors": group(
            lambda k, sh: k.startswith("aten::add") and sh.startswith(f"[{table}, {table}")),
        "optimizer (aten::_foreach_*, _fused_adam)": group(
            lambda k, sh: k.startswith(("aten::_foreach", "aten::_fused_adam"))),
        "matmuls (aten::mm, addmm, bmm)": group(
            lambda k, sh: k in ("aten::mm", "aten::addmm", "aten::bmm")),
    }
    top_ops = [{"op": r.key, "shapes": str(r.input_shapes)[:120], "calls": r.count / steps,
                "device_ms": dev_us(r) / 1e3 / steps}
               for r in sorted(ops, key=dev_us, reverse=True)[:25] if dev_us(r) > 0]
    top_kernels = [{"kernel": r.key[:120], "calls": r.count / steps,
                    "device_ms": dev_us(r) / 1e3 / steps}
                   for r in sorted(kernels, key=dev_us, reverse=True)[:20]]
    return {"busy_ms": busy, "peak_gib": peak, "groups": groups, "ops": top_ops,
            "kernels": top_kernels}


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--config", nargs="+", default=["grid", "smoke", "parity"],
                   choices=["grid", "smoke", "parity", "big", "huge", "tpu"])
    p.add_argument("--steps", type=int, default=30, help="timed steps a configuration")
    p.add_argument("--profile", type=int, default=0,
                   help="profiled steps a configuration (0: no profile; the card only)")
    p.add_argument("--repeat", action="store_true",
                   help="two runs of REPEAT_STEPS steps from one seed must be bitwise equal")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", type=Path, default=None, help="also write the results here")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def main(args) -> dict:
    from ..data.builder import dataset_from_scene
    from ..data.synthetic import SyntheticSceneConfig, render_scene
    from ..utils import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    scene = render_scene(SyntheticSceneConfig(image_size=128, num_cameras=24, seed=args.seed),
                         device=dev)
    data = dataset_from_scene(scene, dev)
    out: dict = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name in args.config:
        cfg = configs(data.cameras.num_cameras)[name]
        wall, cpu = step_ms(cfg, data, args.seed, args.steps)
        r = {"wall_ms": wall, "cpu_ms": cpu}
        print(f"step_bench: {name}: {wall:.4f} ms/step wall, {cpu:.4f} ms/step of process CPU "
              f"(means of {args.steps})")
        if args.profile:
            r["profile"] = p = profile_steps(cfg, data, args.seed, args.profile)
            print(f"step_bench: {name}: device busy {p['busy_ms']:.4f} ms/step over "
                  f"{args.profile} profiled steps, peak memory {p['peak_gib']:.3f} GiB")
            for g, v in p["groups"].items():
                print(f"step_bench: {name}: {g}: {v['calls']:g} calls, "
                      f"{v['device_ms']:.4f} device ms/step")
            for k in p["kernels"][:10]:
                print(f"step_bench: {name}: kernel {k['kernel']}: {k['calls']:g} calls, "
                      f"{k['device_ms']:.4f} ms/step")
        if args.repeat:
            r["repeat"] = rep = two_runs(cfg, data, args.seed)
            print(f"step_bench: {name}: two runs of {REPEAT_STEPS} steps from one seed on the "
                  f"same draws: {rep}")
        out[name] = r
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    if args.repeat and not all(out[n]["repeat"]["bitwise"] for n in args.config):
        raise SystemExit("step_bench: two runs from one seed were not bitwise equal")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_args(ap)
    main(ap.parse_args(sys.argv[1:]))
