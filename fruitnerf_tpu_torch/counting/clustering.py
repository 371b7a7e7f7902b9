"""Cascaded fruit counting: DBSCAN -> merge small -> split large -> count.

Rebuild of the reference's clustering core (clustering/clustering_base.py):

  count (:513-538):
    cluster (:183-207): radius-outlier removal -> voxel downsample ->
      DBSCAN(eps, min_samples) -> first_stage = #clusters
    merge_small_clusters (:209-259): fuse cluster centers closer than
      ``cluster_merge_distance`` -> fused = #merges
    split_large_cluster (:261-511): per cluster, compare volume against the
      template:
        vol > template_vol / 0.9  -> try k=1 (scaled-ICP template fit) and
          k=2..6 (agglomerative split + template placed at each center),
          score each by Hausdorff distance, take argmin k -> additional += k-1
        vol < minimum_size_factor * template_vol -> pruned += 1
    count = first_stage - fused + additional - pruned (:487)

  GT evaluation (:456-509): match predicted centers to GT fruit centers
  within 0.15 scene units -> TP/FP/FN, precision/recall/F1, detection rate.

Volume proxy: convex hull instead of alphashape(10) — see
pointcloud.convex_hull_volume. Agglomerative split: Ward linkage via scipy.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

from .dbscan import dbscan
from .icp import scaled_icp
from .pointcloud import (
    convex_hull_volume,
    hausdorff_distance,
    radius_outlier_removal,
    voxel_downsample,
)
from .templates import load_or_make_template

GT_MATCH_TOLERANCE = 0.15  # clustering_base.py:473
MAX_SPLIT_K = 6  # k in 2..6 (clustering_base.py:281-319)


@dataclasses.dataclass
class CountingProfile:
    """One scene's counting hyperparameters (the dict profiles of
    clustering/config_synthetic.py + config_real.py)."""

    name: str = "scene"
    path: str | None = None  # semantic_colormap.ply
    template: str = "apple"  # kind name or .ply path
    template_size: float = 1.0  # 'apple_template_size'
    remove_outliers_nb_points: int = 200
    remove_outliers_radius: float = 0.01
    down_sample: float = 0.001
    eps: float = 0.01
    min_samples: int = 100
    cluster_merge_distance: float = 0.04
    minimum_size_factor: float = 0.3
    # Split-branch gate: try k>1 when cluster_vol > gate * template_vol.
    # Reference semantics: alphashape(10) volume with gate 1/0.9
    # (clustering_base.py:372). This build measures volume with a CONVEX HULL
    # surrogate, which over-reads fat threshold-band shells (a complete
    # single-fruit shell's hull already equals ~1 full template volume);
    # profiles raise the gate to compensate (round-5 full-cascade
    # calibration on committed orchard exports: 1.6 — NOTES_ROUND5).
    split_volume_gate: float = 1.0 / 0.9
    # Hausdorff penalty (scene units) per extra template when choosing k:
    # best_k = argmin_k score(k) + penalty*(k-1). The raw argmin drifts to
    # large k on dense clouds because Ward splits beyond the true k barely
    # change the score (flat tail) — measured round 5 on the committed
    # round-4 clouds: raw argmin over-split +37/+25/+56 gross vs +12/+10/+39
    # at penalty 0.35*fruit_radius (scripts_dev/calib_split.py); the
    # production orchard profile lands on 0.2*fruit_radius by full-cascade
    # F1 (scripts_dev/simulate_cascade.py). 0.0 reproduces the reference
    # argmin (clustering_base.py:382-411).
    split_k_penalty: float = 0.0
    gt_cluster: str | np.ndarray | None = None  # fruits.obj or [K,3] centers
    gt_count: int | None = None


@dataclasses.dataclass
class CountResult:
    count: int
    first_stage: int
    fused: int
    additional: int
    pruned: int
    centers: np.ndarray
    metrics: dict


def load_obj_fruit_centers(path) -> np.ndarray:
    """Per-fruit GT centers from an OBJ with one object ('o ...') per fruit
    (clustering_base.py:67-111 reads per-fruit OBJ groups)."""
    centers = []
    current: list = []
    with open(path) as f:
        for line in f:
            if line.startswith(("o ", "g ")):
                if current:
                    centers.append(np.mean(current, axis=0))
                    current = []
            elif line.startswith("v "):
                current.append([float(v) for v in line.split()[1:4]])
    if current:
        centers.append(np.mean(current, axis=0))
    return np.asarray(centers, np.float32)


class FruitClustering:
    def __init__(self, profile: CountingProfile, template_points: np.ndarray | None = None,
                 device="cuda"):
        self.profile = profile
        self.device = device  # where the device engine runs, if the cascade reaches it
        self.template = (
            template_points
            if template_points is not None
            else load_or_make_template(profile.template, profile.template_size)
        )
        self.template_volume = convex_hull_volume(self.template)

    # ---------------------------------------------------------------- stages

    def cluster(self, points: np.ndarray):
        p = self.profile
        cleaned = radius_outlier_removal(
            points, p.remove_outliers_nb_points, p.remove_outliers_radius, self.device
        )
        down = voxel_downsample(cleaned, p.down_sample)
        labels = dbscan(down, p.eps, p.min_samples, self.device)
        return down, labels

    @staticmethod
    def _cluster_lists(points, labels):
        n_clusters = int(labels.max()) + 1 if len(labels) else 0
        return [points[labels == lab] for lab in range(n_clusters)]

    def merge_small_clusters(self, clusters):
        """Fuse clusters whose centers are closer than merge_distance
        (union-find over the center graph)."""
        centers = np.array([c.mean(axis=0) for c in clusters])
        n = len(centers)
        if n == 0:
            return clusters, 0
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        for i in range(n):
            for j in range(i + 1, n):
                if d[i, j] < self.profile.cluster_merge_distance:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[ri] = rj
        groups: dict = {}
        for i in range(n):
            groups.setdefault(find(i), []).append(i)
        merged = [np.concatenate([clusters[i] for i in g]) for g in groups.values()]
        fused = n - len(merged)
        return merged, fused

    def _fit_score_k(self, cluster: np.ndarray, k: int) -> float:
        """Hausdorff distance between the cluster and k placed templates."""
        if k == 1:
            fitted, _ = scaled_icp(self.template + cluster.mean(axis=0), cluster)
            return hausdorff_distance(cluster, fitted)
        # agglomerative (Ward) split into k parts, template at each center
        sub = cluster
        if len(sub) > 3000:  # linkage is O(n^2); subsample for tractability
            sel = np.random.RandomState(0).choice(len(sub), 3000, replace=False)
            sub = sub[sel]
        lk = linkage(sub, method="ward")
        assign = fcluster(lk, t=k, criterion="maxclust")
        placed = []
        for i in range(1, k + 1):
            part = sub[assign == i]
            if len(part) == 0:
                continue
            placed.append(self.template + part.mean(axis=0))
        return hausdorff_distance(cluster, np.concatenate(placed))

    def split_large_cluster(self, clusters):
        """Volume-vs-template cascade -> (additional, pruned, kept_centers)."""
        additional = 0
        pruned = 0
        centers = []
        counts_per_cluster = []
        p = self.profile
        for cl in clusters:
            vol = convex_hull_volume(cl)
            if vol > p.split_volume_gate * self.template_volume:
                scores = {
                    k: self._fit_score_k(cl, k) + p.split_k_penalty * (k - 1)
                    for k in range(1, MAX_SPLIT_K + 1)
                }
                best_k = min(scores, key=scores.get)
                additional += best_k - 1
                counts_per_cluster.append(best_k)
                if best_k == 1:
                    centers.append(cl.mean(axis=0))
                else:
                    sub = cl
                    if len(sub) > 3000:
                        sel = np.random.RandomState(0).choice(len(sub), 3000, replace=False)
                        sub = sub[sel]
                    assign = fcluster(linkage(sub, method="ward"), t=best_k,
                                      criterion="maxclust")
                    for i in range(1, best_k + 1):
                        part = sub[assign == i]
                        if len(part):
                            centers.append(part.mean(axis=0))
            elif self.profile.minimum_size_factor * self.template_volume > abs(vol):
                pruned += 1  # clustering_base.py:422-427
                counts_per_cluster.append(0)
            else:
                centers.append(cl.mean(axis=0))
                counts_per_cluster.append(1)
        return additional, pruned, np.asarray(centers).reshape(-1, 3)

    # ------------------------------------------------------------------- api

    def count(self, points_or_path) -> CountResult:
        if isinstance(points_or_path, (str, Path)):
            from ..export.ply import read_ply

            points = read_ply(points_or_path)["points"]
        else:
            points = np.asarray(points_or_path, np.float32)

        down, labels = self.cluster(points)
        clusters = self._cluster_lists(down, labels)
        first_stage = len(clusters)
        clusters, fused = self.merge_small_clusters(clusters)
        additional, pruned, centers = self.split_large_cluster(clusters)
        count = first_stage - fused + additional - pruned  # clustering_base.py:487

        metrics = {}
        gt = self.profile.gt_cluster
        if gt is not None:
            gt_centers = (
                load_obj_fruit_centers(gt) if isinstance(gt, (str, Path)) else np.asarray(gt)
            )
            metrics = evaluate_against_gt(centers, gt_centers)
        if self.profile.gt_count is not None:
            metrics["gt_count"] = self.profile.gt_count
            metrics["count_error"] = count - self.profile.gt_count
        return CountResult(
            count=int(count),
            first_stage=first_stage,
            fused=fused,
            additional=additional,
            pruned=pruned,
            centers=centers,
            metrics=metrics,
        )


def evaluate_against_gt(
    pred_centers: np.ndarray,
    gt_centers: np.ndarray,
    tolerance: float = GT_MATCH_TOLERANCE,
) -> dict:
    """Greedy center matching within tolerance -> detection metrics
    (clustering_base.py:456-509)."""
    if len(pred_centers) == 0 or len(gt_centers) == 0:
        tp = 0
    else:
        d = np.linalg.norm(pred_centers[:, None] - gt_centers[None], axis=-1)
        tp = 0
        used_gt: set = set()
        for i in np.argsort(d.min(axis=1)):
            j = int(np.argmin(np.where(
                np.isin(np.arange(d.shape[1]), list(used_gt)), np.inf, d[i]
            )))
            if d[i, j] <= tolerance and j not in used_gt:
                used_gt.add(j)
                tp += 1
    fp = len(pred_centers) - tp
    fn = len(gt_centers) - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "TP": tp,
        "FP": fp,
        "FN": fn,
        "precision": precision,
        "recall": recall,
        "F1": f1,
        "detection_rate": recall,
    }
