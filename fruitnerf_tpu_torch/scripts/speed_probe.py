"""Step-rate probe for north-star recipe candidates (VERDICT r3 task 3).
Twin of ``fruitnerf_tpu/scripts/speed_probe.py``.

Times the eager train step (``engine/trainer.train_step``, through
``scripts/step_bench.py:step_ms``) for a set of grid-flagship recipe
variations on the card and prints one JSON line per candidate: ms a step
(median and min over ``--repeats`` passes of ``--reps x --chunk`` steps,
synchronised), rays/s and the ratio to the ~136,533 rays/s reference anchor
(30k x 4096 / 15 min, the reference README.md:195). Each row names the card
and its power limit. Pure speed — quality is validated separately by a 30k
orchard-e2e run at the winning recipe.

    python -m fruitnerf_tpu_torch speed-probe --output out/speed_probe.json \\
        [--only default_mid4096f4,uniform_T8192]

The twin times ``lax.scan`` chunks of ``--chunk`` steps; here a chunk is
only a count of eager steps. It runs on the card unless ``--device cpu``
asks for the CPU (whose rows then say ``"device": "cpu"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--output", default=None)
    p.add_argument("--chunk", type=int, default=25)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--repeats", type=int, default=3,
                   help="independent timing passes per recipe; median and "
                        "min are reported (VERDICT r4: single-shot probes "
                        "showed ~45%% run-to-run variance)")
    p.add_argument("--only", default=None,
                   help="comma-separated candidate names to probe")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


BASELINE_RAYS_PER_SEC = 30_000 * 4096 / (15 * 60)


def candidates():
    """(name, {config overrides}) — levers named by VERDICT r3 task 3.

    The mid/fine rows are the two-tier capacity retune: kernel cost is
    linear in sum(T_l), so capping the mid levels while the finest keep
    (or grow) their tables cuts the encode without touching the detail
    levels (GridEncodingConfig.mid_table_size)."""
    return [
        # the preset default is now the two-tier mid4096f4 recipe (round-5
        # flagship promotion, configs.fruit_nerf)
        ("default_mid4096f4", {}),
        # round-4's uniform-8192 default, expressed under the tiered preset:
        # fine_levels=16 puts table_size on every level (cut=0), which the
        # layout collapses back to the uniform case
        ("uniform_T8192", {"fine_levels": 16}),
        ("L14", {"grid_levels": 14}),
        ("L12", {"grid_levels": 12}),
        ("T4096", {"table_size": 4096}),
        ("L12_T4096", {"grid_levels": 12, "table_size": 4096}),
        ("s40", {"nerf_samples": 40}),
        ("L12_s40", {"grid_levels": 12, "nerf_samples": 40}),
        ("L14_T4096", {"grid_levels": 14, "table_size": 4096}),
        ("mid4096_fine4", {"mid_table_size": 4096, "fine_levels": 4}),
        ("mid4096_fine2_T16384",
         {"mid_table_size": 4096, "fine_levels": 2, "table_size": 16384}),
        ("mid2048_fine4", {"mid_table_size": 2048, "fine_levels": 4}),
        # inverted two-tier: the finest levels are already 100-2000x
        # oversubscribed at T=8192 (collision-averaging regime), while the
        # MID octaves (res ~60-300) sit at the occupancy crossover where
        # halving T doubles real aliasing — the mid4096 fine4 283-run's +20
        # phantom-split FPs live there (NOTES_ROUND4). So cut the fine
        # tables, keep the mid ones: mid (all but the last fine_levels) stay
        # 8192, finest drop to table_size
        ("fine4096_last6", {"table_size": 4096, "mid_table_size": 8192,
                            "fine_levels": 6}),
        ("fine4096_last8", {"table_size": 4096, "mid_table_size": 8192,
                            "fine_levels": 8}),
        ("fine4096_last10", {"table_size": 4096, "mid_table_size": 8192,
                             "fine_levels": 10}),
        ("fine2048_last6", {"table_size": 2048, "mid_table_size": 8192,
                            "fine_levels": 6}),
        ("fine4096_last8_s44", {"table_size": 4096, "mid_table_size": 8192,
                                "fine_levels": 8, "nerf_samples": 44}),
        ("s44", {"nerf_samples": 44}),
    ]


def candidate_config(num_images: int, overrides: dict):
    """The ``fruit_nerf`` grid preset at 4096 rays a step with a
    candidate's overrides."""
    from ..configs import apply_overrides, fruit_nerf

    config = dataclasses.replace(fruit_nerf(num_images, variant="grid"),
                                 train_rays_per_batch=4096)
    return apply_overrides(config, overrides)


def card(dev) -> str:
    """``name, power limit`` of the card as nvidia-smi gives them, or
    ``cpu``."""
    import subprocess

    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"], capture_output=True, text=True, check=True).stdout.strip()


def main(args):
    import torch

    from ..data.builder import dataset_from_scene
    from ..data.synthetic import SyntheticSceneConfig, render_scene
    from ..utils import resolve_device
    from .step_bench import step_ms

    dev = resolve_device(args.device)
    scene = render_scene(
        SyntheticSceneConfig(
            num_fruits=6, num_cameras=24, image_size=128, num_leaves=20
        ), device=dev,
    )
    data = dataset_from_scene(scene, dev)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    card_line = card(dev)

    cands = candidates()
    if args.only:
        want = set(args.only.split(","))
        cands = [(n, ov) for n, ov in cands if n in want]

    rows = []
    steps = args.reps * args.chunk
    for i, (name, ov) in enumerate(cands):
        config = candidate_config(data.cameras.num_cameras, ov)
        rays_per_step = config.train_rays_per_batch
        # first candidate warms the card/runtime extra (VERDICT r4 weak #3:
        # the first-measured row was the one that moved between probe runs)
        warm = (4 if i == 0 else 2) * args.chunk
        # independent repeats -> median + min, not a single-shot number
        per_step_ms = [step_ms(config, data, 0, steps, warmup=warm if r == 0 else 0)[0]
                       for r in range(args.repeats)]
        med = statistics.median(per_step_ms)
        rays = rays_per_step / (med * 1e-3)
        row = {
            "name": name, "overrides": ov,
            "ms_per_step": med,
            "ms_per_step_min": min(per_step_ms),
            "ms_per_step_all": per_step_ms,
            "rays_per_sec": rays,
            "rays_per_sec_max": rays_per_step / (min(per_step_ms) * 1e-3),
            "vs_baseline": rays / BASELINE_RAYS_PER_SEC,
            "device": device, "card": card_line,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.output:
        from pathlib import Path

        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    add_args(p)
    main(p.parse_args())
