"""Convergence runs of the main path, held against the JAX package's
recorded run. The port's own tool (no JAX twin).

    python -m fruitnerf_tpu_torch.scripts.convergence --iters 2500 \\
        --runs headline:42 headline:43 bench:42 bench:43 --root runs/settle \\
        --json runs/settle.json

A run is ``<scene>:<train seed>[:<path>]``. The scenes:

* ``headline``: ``reports/round5/headline283_30k_clean``'s arguments (283
  fruits, 300 cameras at 512^2, scene seed 7, export N 512), whose
  ``metrics.jsonl`` the readings are printed beside;
* ``bench``: ``bench.py``'s orchard (120 fruits, 200 cameras at 256^2,
  scene seed 7, export N 384).

The paths (``e2e`` when left out):

* ``e2e``: ``scripts/orchard_e2e.py:main`` at the scene's arguments with
  ``--iters`` steps and ``--sparsity-loss 0.005``: train, evaluate, export,
  count. The config's train seed is the run's, and every optimizer group
  decays over ``--schedule-iters`` (the record's 30000) instead of
  ``--iters``, so the first steps run at the record's learning rates
  (``--schedule-iters 0``: over ``--iters``, as the entry point alone
  runs; with train seed 42 that is ``orchard-e2e --iters <iters>``);
* ``scene``: the same data and config through ``train_loop`` alone, then
  ``evaluate_all`` over the held-out cameras (no export);
* ``frame``: as ``scene``, with the cameras moved into the frame the
  dataparser gives a capture of the scene (centred on the mean camera,
  scaled into the unit box);
* ``split``: as ``scene``, training on 0.9 of the cameras (a capture's
  default) instead of orchard-e2e's 0.95;
* ``capture``: the scene written as a capture (``data/fixture.py``, PNG
  masks, an explicit 0.1 val split), parsed and loaded as ``train --data``
  loads it, then as ``scene``.

Each run's directory under ``--root`` keeps its ``metrics.jsonl``. The JSON
holds, a run, every logged step's losses and every eval, the final eval
over all held-out cameras, and for ``e2e`` the export's points, the
counts and the share of each semantic cloud within 2 fruit radii of a GT
centre; and the record's logged steps up to ``--iters``.

    python -m fruitnerf_tpu_torch.scripts.convergence --summarize a.json b.json

prints the runs of earlier ``--json`` files as PERF.md's tables, and

    python -m fruitnerf_tpu_torch.scripts.convergence --replay replay.pt \\
        --json runs/replay.json

trains instead the small orchard of a replay file that
``tests/torch_jax_windows.py --save-replay`` wrote (the JAX package's
initialisation and draws of every step, and its readings on the CPU) on
the device, and prints the window means of both sides and their ratio.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

RECORD = Path(__file__).resolve().parents[2] / "reports/round5/headline283_30k_clean"
SCENES = {
    "headline": dict(num_fruits=283, num_cameras=300, image_size=512, seed=7, export_n=512),
    "bench": dict(num_fruits=120, num_cameras=200, image_size=256, seed=7, export_n=384),
}
PATHS = ("e2e", "scene", "frame", "split", "capture")
READ = ("semantics_loss", "psnr", "rgb_loss", "distortion", "interlevel_loss", "sparsity_loss")
WINDOW_KEYS = ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss",
               "distortion", "psnr")


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--runs", nargs="+", default=[],
                   help="<scene>:<train seed>[:<path>], scene in "
                        f"{sorted(SCENES)}, path in {list(PATHS)} (default e2e)")
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--schedule-iters", type=int, default=30000,
                   help="the learning-rate decay horizon of every group (0: --iters)")
    p.add_argument("--root", default="runs/convergence", help="a directory a run under it")
    p.add_argument("--summarize", nargs="+", default=None,
                   help="--json files of earlier runs: print their tables and exit")
    p.add_argument("--replay", default=None,
                   help="a tests/torch_jax_windows.py --save-replay file to train instead")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda")


def parse_run(text: str) -> tuple[str, int, str]:
    scene, seed, *rest = text.split(":")
    path = rest[0] if rest else "e2e"
    if scene not in SCENES or path not in PATHS:
        raise ValueError(f"run {text!r}: scene in {sorted(SCENES)}, path in {list(PATHS)}")
    return scene, int(seed), path


def with_seed_and_schedule(config, seed: int, schedule_iters: int):
    """``config`` with train seed ``seed`` and every group decaying over
    ``schedule_iters`` steps (0: over the run's ``max_iters``)."""
    groups = ("fields_opt", "appearance_opt", "proposal_opt", "camera_opt")
    return dataclasses.replace(config, seed=seed, **{
        g: dataclasses.replace(getattr(config, g), max_steps=schedule_iters or None)
        for g in groups})


def near_share(points: np.ndarray, centers: np.ndarray, radius: float) -> float:
    """Share of ``points`` within 2 ``radius`` of a centre."""
    if len(points) == 0:
        return 0.0
    d = np.full(len(points), np.inf)
    for c in centers:
        d = np.minimum(d, np.linalg.norm(points - c, axis=-1))
    return float(np.mean(d < 2.0 * radius))


def read_log(path: Path, iters: int) -> dict:
    """The train rows (``READ``) and the eval rows of a ``metrics.jsonl`` up
    to step ``iters``."""
    rows = [json.loads(x) for x in Path(path).read_text().splitlines()]
    rows = [r for r in rows if r["step"] <= iters]
    train = [{"step": r["step"], **{k: r[k] for k in READ if k in r}}
             for r in rows if "semantics_loss" in r]
    evals = [{"step": r["step"], "iou": r["eval_iou"], "psnr": r["eval_psnr"]}
             for r in rows if "eval_iou" in r]
    return {"train": train, "evals": evals}


def capture_frame(poses: np.ndarray) -> np.ndarray:
    """The poses in the frame ``data/dataparser.py`` gives their capture
    (orientation "up", centred on the poses, scaled into the unit box)."""
    from ..cameras.poses import auto_orient_and_center_poses, auto_scale_poses

    oriented, _ = auto_orient_and_center_poses(poses, method="up", center_method="poses")
    return auto_scale_poses(oriented)[0].astype(np.float32)


def scene_data(scene_kw: dict, path: str, dev, tmp: Path):
    """(dataset, eval indices) of a non-e2e path."""
    from ..data.builder import dataset_from_parsed, dataset_from_scene
    from ..data.dataparser import DataParserConfig, parse_transforms
    from ..data.fixture import write_scene_capture
    from ..data.synthetic import cached_render_scene, orchard_config

    cfg_scene = orchard_config(**{k: v for k, v in scene_kw.items() if k != "export_n"})
    scene = cached_render_scene(cfg_scene, device=dev)
    if path == "capture":
        write_scene_capture(scene, tmp / "capture", eval_fraction=0.1)
        parsed = parse_transforms(DataParserConfig(data_dir=tmp / "capture"))
        return dataset_from_parsed(parsed, dev), np.asarray(parsed.eval_indices)
    if path == "frame":
        scene = {**scene, "poses": capture_frame(scene["poses"])}
    data = dataset_from_scene(scene, dev, train_fraction=0.9 if path == "split" else 0.95)
    train = set(data.train_indices.tolist())
    return data, np.asarray([i for i in range(len(scene["poses"])) if i not in train] or [0])


def run_loop(scene_kw: dict, seed: int, path: str, args, out: Path, dev) -> dict:
    import torch

    from ..configs import apply_overrides, run_preset
    from ..engine.trainer import evaluate_all, train_loop
    from ..utils.writer import MetricWriter

    data, eval_idx = scene_data(scene_kw, path, dev, out)
    config = apply_overrides(run_preset("fruit_nerf", data.cameras.num_cameras, "grid"),
                             {"sparsity_loss": 0.005})
    config = with_seed_and_schedule(dataclasses.replace(config, max_iters=args.iters), seed,
                                    args.schedule_iters)
    writer = MetricWriter(out / "metrics.jsonl", also_print=False)
    timings: dict = {}
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    state = train_loop(config, data, eval_indices=eval_idx, generator=gen, writer=writer,
                       timings=timings)
    writer.close()
    return {"eval": evaluate_all(state.params, data, eval_idx, config), "loop_timings": timings}


def run_e2e(scene_kw: dict, seed: int, args, out: Path) -> dict:
    from ..data.synthetic import fruit_centers, orchard_config
    from ..export.ply import read_ply
    from . import orchard_e2e

    p = argparse.ArgumentParser()
    orchard_e2e.add_args(p)
    e2e_args = p.parse_args([
        "--num-fruits", str(scene_kw["num_fruits"]),
        "--num-cameras", str(scene_kw["num_cameras"]),
        "--image-size", str(scene_kw["image_size"]), "--seed", str(scene_kw["seed"]),
        "--iters", str(args.iters), "--export-n", str(scene_kw["export_n"]),
        "--sparsity-loss", "0.005", "--output-dir", str(out), "--device", args.device,
    ])
    report = orchard_e2e.main(
        e2e_args, adjust=lambda c: with_seed_and_schedule(c, seed, args.schedule_iters))
    cfg_scene = orchard_config(**{k: v for k, v in scene_kw.items() if k != "export_n"})
    centers, radius = fruit_centers(cfg_scene), cfg_scene.fruit_radius
    near = {}
    for cloud in ("semantic", "semantic_colormap"):
        pts = read_ply(out / f"{cloud}.ply")["points"]
        near[cloud] = near_share(np.asarray(pts, np.float64), centers, radius)
    keep = ("eval", "export_points", "counting", "loop_timings", "train_rays_per_sec_train_only",
            "render_scene_s", "export_s", "count_s", "gt_count", "device")
    return {**{k: report.get(k) for k in keep}, "near": near}


def replay(path, dev) -> dict:
    """Train the replay file's orchard on ``dev`` from its initialisation on
    its draws; -> its per-step metrics and window means beside the JAX
    package's, with an eval of one held-out camera at each window's end."""
    import torch

    from ..bridge import tree_map
    from ..configs import apply_overrides, fruit_nerf
    from ..data.builder import dataset_from_scene
    from ..data.synthetic import orchard_config, render_scene
    from ..engine import trainer
    from ..utils import metrics as M

    rp = torch.load(path, weights_only=False)
    a = rp["args"]
    dtype = getattr(torch, a["dtype"])
    scene = render_scene(orchard_config(num_fruits=a["num_fruits"], num_cameras=a["num_cameras"],
                                        image_size=a["image_size"], seed=7), dev)
    data = dataset_from_scene(scene, dev, 0.95)
    n = len(scene["poses"])
    cfg = apply_overrides(fruit_nerf(n, compute_dtype=dtype),
                          {"sparsity_loss": 0.005, "train_rays_per_batch": a["rays"]})
    cfg = dataclasses.replace(cfg, max_iters=a["steps"], model=dataclasses.replace(
        cfg.model, proposal_nets=tuple(dataclasses.replace(q, compute_dtype=dtype)
                                       for q in cfg.model.proposal_nets)))
    params = tree_map(rp["params"], lambda t: t.detach().to(dev))
    state = trainer.init_train_state(cfg, n, dev, params=params)
    steps, windows = [], []
    for s, d in enumerate(rp["draws"]):
        draws = trainer.StepDraws(**{
            k: v.to(dev) if torch.is_tensor(v) else [u.to(dev) for u in v] for k, v in d.items()})
        m = trainer.train_step(state, data, cfg, draws=draws)
        steps.append({k: float(m[k]) for k in WINDOW_KEYS})
        if (s + 1) % a["window"] == 0:
            cam = rp["held"][(s // a["window"]) % len(rp["held"])]
            out = trainer.render_camera(state.params, data.cameras, cam, cfg)
            gt = data.images[cam].float() / 255.0
            w = {k: float(np.mean([r[k] for r in steps[-a["window"]:]])) for k in WINDOW_KEYS}
            w.update(eval_accumulation=float(out["accumulation"].mean()),
                     eval_psnr=float(M.psnr(out["rgb"], gt)),
                     eval_iou=float(M.binary_iou(out["semantics"][..., 0],
                                                 data.masks[cam].float())))
            jw = rp["jax"]["windows"][len(windows)]
            windows.append({"steps": [s + 1 - a["window"], s], "port": w, "jax": jw})
            print(f"replay: steps {s + 1 - a['window']}-{s}: " + "; ".join(
                f"{k} {jw[k]:.5g} / {w[k]:.5g}" + (f" ({w[k] / jw[k]:.3f})" if jw[k] else "")
                for k in w), flush=True)
    return {"args": a, "steps": steps, "windows": windows}


def summarize(paths) -> list[str]:
    """Markdown tables of the runs in ``paths`` (``--json`` files), the
    record first: eval IoU and PSNR at each eval; the final eval, counts
    and near shares of the e2e runs; ``semantics_loss`` every 100 steps."""
    files = [json.loads(Path(f).read_text()) for f in paths]
    record = next(f["record"] for f in files if "record" in f)
    runs = [("record (JAX, TPU v5e)", record, None)] + [
        (f"{r['run']} ({f['iters']} steps, schedule {f['schedule_iters'] or f['iters']})", r, r)
        for f in files for r in f["runs"]]
    steps = sorted({e["step"] for _, r, _ in runs for e in r["evals"]})
    lines = ["| run | " + " | ".join(f"IoU / PSNR at {s}" for s in steps)
             + " | final IoU / PSNR | semantic, colormap: count (near) |",
             "| --- |" + " --- |" * (len(steps) + 2)]
    for label, r, run in runs:
        ev = {e["step"]: f"{e['iou']:.3f} / {e['psnr']:.2f}" for e in r["evals"]}
        final = counted = ""
        if run is not None:
            final = f"{run['eval']['iou']:.3f} / {run['eval']['psnr']:.2f}"
            if "near" in run:
                counted = ", ".join(
                    f"{run['counting'][c]['count']} ({run['near'][c]:.3f})"
                    for c in ("semantic", "semantic_colormap"))
        lines.append(f"| {label} | " + " | ".join(ev.get(s, "") for s in steps)
                     + f" | {final} | {counted} |")
    lines += ["", "| run | " + " | ".join(f"`semantics_loss` at {a}-{a + 400}"
                                        for a in range(100, 2500, 500)) + " |",
              "| --- |" + " --- |" * 5]
    for label, r, _ in runs:
        sl = {t["step"]: t["semantics_loss"] for t in r["train"]}
        lines.append(f"| {label} | " + " | ".join(
            "/".join(f"{sl[s]:.3f}" for s in range(a, a + 500, 100) if s in sl)
            for a in range(100, 2500, 500)) + " |")
    return lines


def main(args) -> dict:
    import torch

    if args.summarize:
        print("\n".join(summarize(args.summarize)))
        return {}

    from ..utils import resolve_device

    dev = resolve_device(args.device)
    if args.replay:
        res = replay(args.replay, dev)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(res, indent=1))
        return res
    root = Path(args.root)
    results = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "iters": args.iters, "schedule_iters": args.schedule_iters, "runs": []}
    record = RECORD / "metrics.jsonl"
    if record.exists():
        results["record"] = {"dir": str(RECORD.relative_to(RECORD.parents[2])),
                             **read_log(record, args.iters)}
    for text in args.runs:
        scene, seed, path = parse_run(text)
        out = root / f"{scene}_{seed}_{path}"
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        if path == "e2e":
            res = run_e2e(SCENES[scene], seed, args, out)
        else:
            res = run_loop(SCENES[scene], seed, path, args, out, dev)
        run = {"run": text, "scene": scene, "seed": seed, "path": path,
               "wall_s": time.perf_counter() - t0, **res,
               **read_log(out / "metrics.jsonl", args.iters)}
        results["runs"].append(run)
        line = [f"eval at {e['step']}: IoU {e['iou']:.4f}, PSNR {e['psnr']:.3f}"
                for e in run["evals"]] + [f"final eval {json.dumps(run['eval'])}"]
        if "near" in run:
            line.append(f"counts {json.dumps(run['counting'])}; near {run['near']}")
        print(f"convergence: {text}: " + "; ".join(line), flush=True)
        if args.json:  # after every run, so a cut call keeps what ran
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_args(p)
    main(p.parse_args())
