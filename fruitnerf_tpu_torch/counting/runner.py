"""Counting runners: per-profile counting + hyperparameter sweep.

Equivalents of clustering/run_clustering.py (iterates profiles, writes
``results_synthetic.json`` with count/TP/gt/precision/recall/F1,
:94-130) and run_clustering_sweep.py (grid over nb_points x eps x
template_size, :141-201).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .clustering import CountingProfile, FruitClustering


def run_profiles(
    profiles: dict[str, CountingProfile],
    clouds: dict[str, object] | None = None,
    output_path=None,
    device="cuda",
) -> dict:
    """Count each profile's cloud. ``clouds`` overrides profile.path per name
    (array or .ply path); ``device`` is where the cascade's device engine
    runs, if it is reached. Returns + optionally writes the results dict."""
    results = {}
    for name, profile in profiles.items():
        src = (clouds or {}).get(name, profile.path)
        if src is None:
            results[name] = {"skipped": "no point cloud provided"}
            continue
        clustering = FruitClustering(profile, device=device)
        res = clustering.count(src)
        results[name] = {
            "count": res.count,
            "first_stage": res.first_stage,
            "fused": res.fused,
            "additional": res.additional,
            "pruned": res.pruned,
            **{
                k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                for k, v in res.metrics.items()
            },
        }
        print(f"[{name}] count={res.count} metrics={res.metrics}", flush=True)
    if output_path is not None:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def run_sweep(
    profile: CountingProfile,
    cloud,
    nb_points_grid=(50, 100, 150),
    eps_grid=(0.01, 0.02, 0.03),
    template_size_grid=(0.7, 1.0, 1.3),
    output_path=None,
    device="cuda",
) -> list[dict]:
    """Grid-search counting hyperparameters (run_clustering_sweep.py:141-201)."""
    rows = []
    for nb in nb_points_grid:
        for eps in eps_grid:
            for ts in template_size_grid:
                p = dataclasses.replace(
                    profile,
                    remove_outliers_nb_points=nb,
                    eps=eps,
                    template_size=ts,
                )
                res = FruitClustering(p, device=device).count(cloud)
                row = {
                    "nb_points": nb,
                    "eps": eps,
                    "template_size": ts,
                    "count": res.count,
                    **res.metrics,
                }
                rows.append(row)
                print(row, flush=True)
    if output_path is not None:
        with open(output_path, "w") as f:
            json.dump(rows, f, indent=2)
    return rows
