"""Counting CLI: the fruit count of an exported cloud through the counting
cascade (numpy, scipy and the native library; the port's copy in
``counting/`` and ``native/``). Twin of ``fruitnerf_tpu/scripts/count.py``.

    python -m fruitnerf_tpu_torch count --cloud out/semantic_colormap.ply \\
        --profile apple --output results.json

An empty or missing ``semantic_colormap.ply`` falls back to the sibling
``semantic.ply``, as in the JAX twin; unlike it, the cloud actually counted
is recorded as ``cloud_used`` in the printed and written results.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--cloud", required=True, help="semantic_colormap.ply path")
    p.add_argument("--profile", default=None,
                   help="named profile (apple, pear, ..., tree_01, fuji)")
    p.add_argument("--template", default="apple")
    p.add_argument("--template-size", type=float, default=1.0)
    p.add_argument("--eps", type=float, default=0.01)
    p.add_argument("--min-samples", type=int, default=100)
    p.add_argument("--remove-outliers-nb-points", type=int, default=200)
    p.add_argument("--remove-outliers-radius", type=float, default=0.01)
    p.add_argument("--down-sample", type=float, default=0.001)
    p.add_argument("--cluster-merge-distance", type=float, default=0.04)
    p.add_argument("--minimum-size-factor", type=float, default=0.3)
    p.add_argument("--gt-count", type=int, default=None)
    p.add_argument("--gt-cluster", default=None, help="fruits.obj GT positions")
    p.add_argument("--output", default=None, help="results JSON path")
    p.add_argument("--sweep", action="store_true",
                   help="grid-search nb_points x eps x template_size")
    p.add_argument("--device", default="cuda",
                   help="where the cascade's device engine runs, if an export-scale "
                        "cloud reaches it without the native library (default: the "
                        "card; 'cpu' asks for the CPU explicitly)")


def native_library() -> Path | None:
    """The native counting library's path once it is built and loaded, else
    None. It builds with g++ at first use; without it the cascade takes the
    numpy grid engine, which gives the same labels far more slowly on an
    export-sized cloud."""
    from .. import native

    return native._SO if native.load() is not None else None


def _profile(args):
    from ..counting.clustering import CountingProfile
    from ..counting.profiles import ALL_PROFILES

    if args.profile:
        if args.profile not in ALL_PROFILES:
            raise KeyError(f"unknown profile {args.profile!r}; choose from {sorted(ALL_PROFILES)}")
        profile = ALL_PROFILES[args.profile]
    else:
        profile = CountingProfile(
            name="cli",
            template=args.template,
            template_size=args.template_size,
            remove_outliers_nb_points=args.remove_outliers_nb_points,
            remove_outliers_radius=args.remove_outliers_radius,
            down_sample=args.down_sample,
            eps=args.eps,
            min_samples=args.min_samples,
            cluster_merge_distance=args.cluster_merge_distance,
            minimum_size_factor=args.minimum_size_factor,
        )
    return dataclasses.replace(
        profile,
        gt_count=profile.gt_count if args.gt_count is None else args.gt_count,
        gt_cluster=profile.gt_cluster if args.gt_cluster is None else args.gt_cluster,
    )


def main(args):
    from ..counting.runner import run_profiles, run_sweep

    profile = _profile(args)
    cloud = _with_semantic_fallback(args.cloud)
    if args.sweep:
        results = [dict(row, cloud_used=cloud)
                   for row in run_sweep(profile, cloud, device=args.device)]
    else:
        results = run_profiles({profile.name: profile}, clouds={profile.name: cloud},
                               device=args.device)
        results[profile.name]["cloud_used"] = cloud
    if args.output is not None:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    return results


def _with_semantic_fallback(cloud_path: str) -> str:
    """Fall back from an empty/missing semantic_colormap.ply to the sibling
    semantic.ply (logit>=3 cloud).

    The colormap cloud needs the sigmoid head to reach >=0.9 — on short runs
    (e.g. the quick-start's 2000-iter smoke demo) or tiny scenes the head may
    not be that saturated yet while the logit>=3 semantic cloud already is
    (same guard the multi-scene campaign applies; threshold semantics per
    reference exporter_utils.py:106-114)."""
    from ..export.ply import read_ply

    p = Path(cloud_path)
    empty = not p.exists()
    if not empty:
        try:
            empty = len(read_ply(p)["points"]) == 0
        except Exception:
            empty = False  # unreadable: let the counter raise its own error
    sibling = p.with_name("semantic.ply")
    if empty and p.name == "semantic_colormap.ply" and sibling.exists():
        print(
            f"[count] {p.name} is empty (semantics not yet colormap-"
            f"saturated at this training length); falling back to {sibling}",
            flush=True,
        )
        return str(sibling)
    return cloud_path
