"""Counting CLI: the fruit count of an exported cloud through the JAX
package's counting cascade (numpy, scipy and the native library). Twin of
``fruitnerf_tpu/scripts/count.py``.

    python -m fruitnerf_tpu_torch count --cloud out/semantic_colormap.ply \\
        --profile apple --output results.json

An empty or missing ``semantic_colormap.ply`` falls back to the sibling
``semantic.ply``, as in the JAX twin; unlike it, the cloud actually counted
is recorded as ``cloud_used`` in the printed and written results.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from fruitnerf_tpu.scripts.count import (  # noqa: F401  (the CLI and fallback are shared)
    _with_semantic_fallback,
    add_args,
)


def native_library() -> Path | None:
    """The native counting library's path once it is built and loaded, else
    None. Without it a cloud of 50k points or more goes to the JAX-only
    device DBSCAN, so the port needs it (it builds with g++ at first use)."""
    from fruitnerf_tpu import native

    return native._SO if native.load() is not None else None


def _profile(args):
    from fruitnerf_tpu.counting.clustering import CountingProfile
    from fruitnerf_tpu.counting.profiles import ALL_PROFILES

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
    from fruitnerf_tpu.counting.runner import run_profiles, run_sweep

    profile = _profile(args)
    cloud = _with_semantic_fallback(args.cloud)
    if args.sweep:
        results = [dict(row, cloud_used=cloud) for row in run_sweep(profile, cloud)]
    else:
        results = run_profiles({profile.name: profile}, clouds={profile.name: cloud})
        results[profile.name]["cloud_used"] = cloud
    if args.output is not None:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    return results
