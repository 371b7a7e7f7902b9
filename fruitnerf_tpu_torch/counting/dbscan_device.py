"""Device DBSCAN and radius neighbor counts for export-scale clouds. Twin
of ``fruitnerf_tpu/counting/dbscan_device.py``, in plain PyTorch tensor
math on a given device (the card unless the caller names the CPU).

The reference leans on sklearn DBSCAN / Open3D C++ with n_jobs=-1
(clustering_base.py:13,200); the numpy grid engine (gridhash.py) is
single-threaded. This module moves the quadratic neighbor math onto the
device:

  * points bucket into cells of size eps/sqrt(3) (host, linear time); every
    within-cell pair is within eps, so cells are cliques;
  * cells pad to [C, K, 3]; all pair distances against the 125 neighbor-cell
    offsets are batched broadcast-subtract-square reductions in the
    difference form, (dx^2 + dy^2) + dz^2 in float32, which stays exact
    near the eps boundary where |a|^2+|b|^2-2ab cancels (so no
    ``torch.cdist``);
  * per-point neighbor counts -> core mask (exact, self included);
  * connectivity reduces to the CELL graph: an edge where any core-core pair
    joins two cells (exact because in-cell core points are cliques);
    components run on the host over ~#cells nodes;
  * border points take the lowest cluster label among core neighbors.

Everything is exact sklearn semantics (tests compare against the BFS
reference implementation). Where the twin maps fixed chunks of 512 cells
over all 125 offsets, this takes as many cells a batch as keep B * K^2
pairs under PAIRS_BUDGET (at least one cell), compares a cell at an offset
only where its partner there is a real cell, and never forms the
[B, K, K, 3] difference tensor: one axis at a time, a [B, K, K] tensor each.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

_PAD = 1.0e9  # padded-point coordinate; d2 >= 1e18 fails any eps test
_BIG = np.int32(2**30)
PAIRS_BUDGET = 1 << 26  # point pairs an offset's batch compares: [B, K, K] float32 = 256 MiB

_OFFSETS = np.array(
    [
        (ox, oy, oz)
        for ox in range(-2, 3)
        for oy in range(-2, 3)
        for oz in range(-2, 3)
    ],
    np.int64,
)  # 125


def _bucket(points: np.ndarray, eps: float):
    """Host prep: cell buckets padded to [C+1, K, 3] (+1 = dummy cell)."""
    cell = eps / np.sqrt(3.0)
    cells = np.floor(points / cell).astype(np.int64)
    cells -= cells.min(axis=0)
    dims = cells.max(axis=0) + 5
    if float(dims[0]) * float(dims[1]) * float(dims[2]) > 2**62:
        return None
    ids = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    uniq, starts = np.unique(sorted_ids, return_index=True)
    counts = np.diff(np.append(starts, len(ids))).astype(np.int64)
    c = len(uniq)
    # bucket K to multiples of 8 for compile-cache reuse
    k = int(counts.max())
    k = (k + 7) // 8 * 8
    cell_of_sorted = np.searchsorted(starts, np.arange(len(points)), side="right") - 1
    rank = np.arange(len(points)) - starts[cell_of_sorted]
    padded = np.full((c + 1, k, 3), _PAD, np.float32)
    padded[cell_of_sorted, rank] = points[order].astype(np.float32)
    # partner cell per (cell, offset); missing/overflow -> dummy index C
    nbr = np.full((c, len(_OFFSETS)), c, np.int32)
    for o, off in enumerate(_OFFSETS):
        partner = uniq + (off[0] * dims[1] + off[1]) * dims[2] + off[2]
        pos = np.searchsorted(uniq, partner)
        pos_c = np.clip(pos, 0, c - 1)
        valid = uniq[pos_c] == partner
        nbr[valid, o] = pos_c[valid]
    point_cell = np.empty(len(points), np.int64)
    point_rank = np.empty(len(points), np.int64)
    point_cell[order] = cell_of_sorted
    point_rank[order] = rank
    return {
        "padded": padded,
        "nbr": nbr,
        "point_cell": point_cell,
        "point_rank": point_rank,
        "num_cells": c,
        "k": k,
    }


def _chunked(bucket):
    """Cell batches of at most PAIRS_BUDGET // K^2 cells (at least one):
    for each, [(offset, the batch's cells whose partner at that offset is a
    real cell)]. A cell whose partner is the padding cell adds nothing at
    that offset in any pass (padded points are far from every real point),
    so it is not compared there."""
    c, k = bucket["num_cells"], bucket["k"]
    b = max(1, PAIRS_BUDGET // (k * k))
    batches = []
    for s in range(0, c, b):
        valid = bucket["nbr"][s : s + b] < c
        batches.append([(o, np.nonzero(valid[:, o])[0] + s)
                        for o in range(len(_OFFSETS)) if valid[:, o].any()])
    return batches


class _Cells:
    """A bucketed cloud on the device: the padded cells split by axis
    ([C+1, K] each), the partner table ([C, 125]) and the batches, each a
    list of (offset, cells) with the cells on the device."""

    def __init__(self, bucket, device):
        self.bucket = bucket
        padded = torch.as_tensor(bucket["padded"], device=device)
        self.axes = [padded[..., a].contiguous() for a in range(3)]
        self.nbr = torch.as_tensor(bucket["nbr"], dtype=torch.int64, device=device)
        self.batches = [[(o, torch.as_tensor(rows, device=device)) for o, rows in batch]
                        for batch in _chunked(bucket)]
        self.device = device

    def d2(self, rows: torch.Tensor, o: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Squared distances [M, K, K] between the points of the cells
        ``rows`` and those of each one's o-th partner, summed x, y, z in
        that order; -> (d2, partner cell ids [M])."""
        pid = self.nbr[rows, o]
        d2 = None
        for ax in self.axes:
            d = ax[rows][:, :, None] - ax[pid][:, None, :]
            d = d.mul_(d)
            d2 = d if d2 is None else d2.add_(d)
        return d2, pid

    def per_point(self, grid: torch.Tensor) -> np.ndarray:
        """[C, K] per-slot values -> [N] per point, on the host."""
        g = grid.cpu().numpy()
        return g[self.bucket["point_cell"], self.bucket["point_rank"]]


def _counts(cells: _Cells, eps2: torch.Tensor) -> torch.Tensor:
    """Per-slot neighbor counts (self included) over all 125 offsets: [C, K]
    int32."""
    c, k = cells.bucket["num_cells"], cells.bucket["k"]
    out = torch.zeros((c, k), dtype=torch.int32, device=cells.device)
    for batch in cells.batches:
        for o, rows in batch:
            d2, _ = cells.d2(rows, o)
            out.index_add_(0, rows, (d2 <= eps2).sum(-1, dtype=torch.int32))
    return out


def _edges(cells: _Cells, core: torch.Tensor, eps2: torch.Tensor) -> torch.Tensor:
    """exists[c, o]: any core-core pair within eps between cell c and its
    o-th offset partner. ``core`` is [C+1, K] bool (the dummy row False)."""
    c = cells.bucket["num_cells"]
    out = torch.zeros((c, len(_OFFSETS)), dtype=torch.bool, device=cells.device)
    for batch in cells.batches:
        for o, rows in batch:
            d2, pid = cells.d2(rows, o)
            ok = (d2 <= eps2) & core[rows][:, :, None] & core[pid][:, None, :]
            out[rows, o] = ok.flatten(1).any(1)
    return out


def _border(cells: _Cells, core: torch.Tensor, cell_label: torch.Tensor,
            eps2: torch.Tensor) -> torch.Tensor:
    """Per slot: lowest partner-cell label among core neighbors (or BIG)."""
    c, k = cells.bucket["num_cells"], cells.bucket["k"]
    out = torch.full((c, k), int(_BIG), dtype=torch.int32, device=cells.device)
    big = torch.tensor(int(_BIG), dtype=torch.int32, device=cells.device)
    for batch in cells.batches:
        for o, rows in batch:
            d2, pid = cells.d2(rows, o)
            hit = ((d2 <= eps2) & core[pid][:, None, :]).any(-1)  # [M, K]
            cand = torch.where(hit, cell_label[pid][:, None], big)
            out[rows] = torch.minimum(out[rows], cand)  # rows are distinct
    return out


def _prepare(points: np.ndarray, radius: float, device):
    from ..utils import resolve_device

    dev = resolve_device(device)
    bucket = _bucket(points, radius)
    if bucket is None:
        return None, None
    return _Cells(bucket, dev), torch.tensor(radius * radius, dtype=torch.float32, device=dev)


def neighbor_counts_device(points: np.ndarray, radius: float,
                           device="cuda") -> np.ndarray | None:
    """Exact within-radius neighbor counts per point (incl. self) on
    ``device``. Returns None when the cell encoding overflows."""
    cells, eps2 = _prepare(points, radius, device)
    if cells is None:
        return None
    return cells.per_point(_counts(cells, eps2)).astype(np.int64)


def radius_neighbor_mask_device(
    points: np.ndarray, radius: float, nb_points: int, device="cuda",
) -> np.ndarray | None:
    """Bool mask of points with >= nb_points neighbors within radius (incl.
    self); the count grid stays on the device, only the mask is read back.
    None when the cell encoding overflows."""
    cells, eps2 = _prepare(points, radius, device)
    if cells is None:
        return None
    return cells.per_point(_counts(cells, eps2) >= nb_points)


def dbscan_device(points: np.ndarray, eps: float, min_samples: int,
                  device="cuda") -> np.ndarray | None:
    """Exact DBSCAN labels (-1 noise) with the quadratic work on
    ``device``. None when the cell encoding overflows."""
    n = len(points)
    labels = np.full(n, -1, np.int32)
    if n == 0:
        return labels
    cells, eps2 = _prepare(points, eps, device)
    if cells is None:
        return None
    bucket = cells.bucket
    dev = cells.device

    core_grid = _counts(cells, eps2) >= min_samples  # [C, K]
    core = cells.per_point(core_grid)
    if not core.any():
        return labels

    c = bucket["num_cells"]
    # padded slots are never core: their coordinates only meet each other
    core_cells = np.zeros((c + 1, bucket["k"]), bool)
    core_cells[bucket["point_cell"], bucket["point_rank"]] = core
    core_t = torch.as_tensor(core_cells, device=dev)
    exists = _edges(cells, core_t, eps2).cpu().numpy()

    # cell graph -> components (host; ~#cells nodes)
    src_cell, off = np.nonzero(exists)
    dst_cell = bucket["nbr"][src_cell, off]
    keep = dst_cell < c
    adj = coo_matrix(
        (np.ones(keep.sum(), np.int8), (src_cell[keep], dst_cell[keep])),
        shape=(c, c),
    )
    _, comp = connected_components(adj, directed=False)

    # order cluster ids by first core point index (sklearn convention)
    core_idx = np.nonzero(core)[0]
    comp_of_core = comp[bucket["point_cell"][core_idx]]
    uniq_comp, first = np.unique(comp_of_core, return_index=True)
    remap = np.full(int(comp.max()) + 1, -1, np.int32)
    remap[uniq_comp[np.argsort(core_idx[first])]] = np.arange(
        len(uniq_comp), dtype=np.int32
    )
    labels[core] = remap[comp[bucket["point_cell"][core_idx]]]

    # border points: lowest label among core neighbors
    cell_label = np.full(c + 1, _BIG, np.int32)
    has_core_cell = np.zeros(c + 1, bool)
    np.logical_or.at(has_core_cell, bucket["point_cell"][core_idx], True)
    cl = remap[comp]
    cell_label[:c] = np.where(has_core_cell[:c], cl, _BIG)
    best = _border(cells, core_t, torch.as_tensor(cell_label, device=dev), eps2)
    best_pt = cells.per_point(best)
    border = (~core) & (best_pt < _BIG)
    labels[border] = best_pt[border]
    return labels
