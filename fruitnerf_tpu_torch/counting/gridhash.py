"""Grid-bucketed neighborhood engine for point-cloud ops at export scale.

The counting cascade's hot neighbor queries (radius-outlier counts, DBSCAN —
clustering_base.py:183-207) are exact-radius problems on millions of
near-uniform export probes. cKDTree ``query_ball_point`` materializes Python
neighbor *lists* (~500 per point at export density; measured 138 s for a
574K-point DBSCAN), so this module replaces it with flat-array bucket joins:

  * cells of size ``radius/sqrt(3)`` — every within-cell pair is certainly
    within radius (cell diagonal = radius), so cells are cliques and
    cross-cell checks only scan a 5x5x5 offset neighborhood;
  * per offset, matching cell pairs are found with one ``searchsorted`` and
    all cross pairs are generated with C-speed ``repeat``/``cumsum`` index
    algebra — no Python per-point loops anywhere;
  * DBSCAN connectivity reduces to ONE representative core-core edge per
    (cell, cell) pair (exact because in-cell core points are cliques), so
    the component pass sees ~#cells edges instead of ~N*density;
  * pairs are streamed in bounded chunks and the scan is a generator — peak
    memory stays ~constant regardless of N.

Semantics match sklearn DBSCAN / open3d remove_radius_outlier (validated in
tests/test_counting.py against brute-force cases).
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

# bound on materialized candidate pairs per chunk (memory control)
_PAIR_CHUNK = 8_000_000


class _CellGrid:
    """Points bucketed into integer cells of the given size."""

    def __init__(self, points: np.ndarray, cell: float):
        cells = np.floor(points / cell).astype(np.int64)
        lo = cells.min(axis=0)
        cells -= lo
        self.dims = cells.max(axis=0).astype(np.int64) + 5  # +-2 offset margin
        self.overflow = (
            float(self.dims[0]) * float(self.dims[1]) * float(self.dims[2])
            > 2**62
        )
        if self.overflow:
            return
        ids = (cells[:, 0] * self.dims[1] + cells[:, 1]) * self.dims[2] + cells[:, 2]
        self.order = np.argsort(ids, kind="stable")  # sorted-pos -> original
        sorted_ids = ids[self.order]
        self.uniq, self.starts = np.unique(sorted_ids, return_index=True)
        self.counts = np.diff(np.append(self.starts, len(ids))).astype(np.int64)
        # original index -> owning cell (index into uniq)
        self.cell_of_point = np.empty(len(points), np.int64)
        self.cell_of_point[self.order] = np.searchsorted(
            self.starts, np.arange(len(points)), side="right"
        ) - 1

    def encode_offset(self, off) -> np.int64:
        return (off[0] * self.dims[1] + off[1]) * self.dims[2] + off[2]


def _cross_pairs(startsA, nA, startsB, nB):
    """All (a, b, k) for cross products of matched cell segments; a/b are
    sorted-order point indices, k the local matched-pair index."""
    sizes = nA * nB
    offs = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offs[-1])
    if total == 0:
        e = np.empty(0, np.int64)
        return e, e, e
    k = np.repeat(np.arange(len(sizes)), sizes)
    t = np.arange(total, dtype=np.int64) - offs[k]
    ai = t // nB[k]
    bi = t - ai * nB[k]
    return startsA[k] + ai, startsB[k] + bi, k


def _chunks(idxA, idxB, counts):
    """Split matched cell-index arrays so each chunk materializes at most
    ~_PAIR_CHUNK candidate pairs."""
    sizes = counts[idxA] * counts[idxB]
    csum = np.cumsum(sizes)
    start = 0
    while start < len(idxA):
        base = csum[start - 1] if start else 0
        stop = int(np.searchsorted(csum, base + _PAIR_CHUNK)) + 1
        stop = min(max(stop, start + 1), len(idxA))
        yield idxA[start:stop], idxB[start:stop]
        start = stop


_HALF_OFFSETS = [
    (ox, oy, oz)
    for ox in range(-2, 3)
    for oy in range(-2, 3)
    for oz in range(-2, 3)
    if (ox, oy, oz) > (0, 0, 0)
]


def neighbor_scan(points: np.ndarray, radius: float, grid: _CellGrid | None = None):
    """Generator over exact within-radius point pairs (unordered, each once).

    Yields (src, dst, cell_src, cell_dst): ORIGINAL point indices + their
    cell indices, filtered to dist <= radius. Returns None if the grid
    encoding would overflow (callers fall back to cKDTree).
    """
    grid = grid or _CellGrid(points, radius / np.sqrt(3.0))
    if grid.overflow:
        return None
    pts_sorted = points[grid.order].astype(np.float32)
    r2 = np.float32(radius * radius)

    def emit(src, dst, ia, ib, k):
        d = pts_sorted[src] - pts_sorted[dst]
        keep = (d * d).sum(axis=1) <= r2
        if not keep.any():
            return None
        src, dst, k = src[keep], dst[keep], k[keep]
        return grid.order[src], grid.order[dst], ia[k], ib[k]

    def gen():
        all_cells = np.arange(len(grid.uniq))
        for ia, ib in _chunks(all_cells, all_cells, grid.counts):
            src, dst, k = _cross_pairs(
                grid.starts[ia], grid.counts[ia], grid.starts[ib], grid.counts[ib]
            )
            keep = src < dst  # in-cell: each unordered pair once
            out = emit(src[keep], dst[keep], ia, ib, k[keep])
            if out is not None:
                yield out
        for off in _HALF_OFFSETS:
            partner = grid.uniq + grid.encode_offset(np.asarray(off, np.int64))
            pos = np.searchsorted(grid.uniq, partner)
            pos_c = np.clip(pos, 0, len(grid.uniq) - 1)
            valid = grid.uniq[pos_c] == partner
            ia_all = np.nonzero(valid)[0]
            if len(ia_all) == 0:
                continue
            ib_all = pos_c[valid]
            for ia, ib in _chunks(ia_all, ib_all, grid.counts):
                src, dst, k = _cross_pairs(
                    grid.starts[ia], grid.counts[ia], grid.starts[ib], grid.counts[ib]
                )
                out = emit(src, dst, ia, ib, k)
                if out is not None:
                    yield out

    return gen()


def neighbor_counts(points: np.ndarray, radius: float) -> np.ndarray:
    """Exact #neighbors within radius per point, INCLUDING self (the
    open3d/sklearn core-point convention)."""
    n = len(points)
    scan = neighbor_scan(points, radius)
    if scan is None:  # coordinate spread too large for dense cell ids
        from scipy.spatial import cKDTree

        tree = cKDTree(points)
        return tree.query_ball_point(points, radius, return_length=True, workers=-1)
    counts = np.ones(n, np.int64)
    for src, dst, _, _ in scan:
        counts += np.bincount(src, minlength=n)
        counts += np.bincount(dst, minlength=n)
    return counts


def dbscan_grid(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Exact DBSCAN labels [N] int32 (-1 noise), sklearn semantics."""
    n = len(points)
    labels = np.full(n, -1, np.int32)
    if n == 0:
        return labels
    grid = _CellGrid(points, eps / np.sqrt(3.0))
    if grid.overflow:
        from .dbscan import dbscan_bfs

        return dbscan_bfs(points, eps, min_samples)

    # pass 1: neighbor counts -> core mask
    counts = np.ones(n, np.int64)
    for src, dst, _, _ in neighbor_scan(points, eps, grid):
        counts += np.bincount(src, minlength=n)
        counts += np.bincount(dst, minlength=n)
    core = counts >= min_samples

    # pass 2 (recomputed scan, bounded memory): connectivity edges
    es_parts, ed_parts = [], []
    border_pt_parts, border_core_parts = [], []
    ncells = len(grid.uniq)
    for src, dst, csrc, cdst in neighbor_scan(points, eps, grid):
        cc = core[src] & core[dst]
        if cc.any():
            # one representative core-core edge per (cellA, cellB): exact,
            # since each cell's core points form a clique (diag <= eps)
            key = csrc[cc] * np.int64(ncells + 1) + cdst[cc]
            _, first = np.unique(key, return_index=True)
            es_parts.append(src[cc][first])
            ed_parts.append(dst[cc][first])
        bc = core[src] & ~core[dst]
        if bc.any():
            border_pt_parts.append(dst[bc])
            border_core_parts.append(src[bc])
        cb = ~core[src] & core[dst]
        if cb.any():
            border_pt_parts.append(src[cb])
            border_core_parts.append(dst[cb])

    # in-cell cliques: chain consecutive core points of each cell
    core_idx = np.nonzero(core)[0]
    if len(core_idx):
        cells_of_core = grid.cell_of_point[core_idx]
        o = np.argsort(cells_of_core, kind="stable")
        cs, ci = cells_of_core[o], core_idx[o]
        same = cs[1:] == cs[:-1]
        es_parts.append(ci[:-1][same])
        ed_parts.append(ci[1:][same])

    es = np.concatenate(es_parts) if es_parts else np.empty(0, np.int64)
    ed = np.concatenate(ed_parts) if ed_parts else np.empty(0, np.int64)
    adj = coo_matrix((np.ones(len(es), np.int8), (es, ed)), shape=(n, n))
    _, comp = connected_components(adj, directed=False)

    if not core.any():
        return labels
    # cluster ids ordered by first core point index (sklearn convention)
    uniq_comp, first = np.unique(comp[core], return_index=True)
    first_point = core_idx[first]
    remap = np.full(int(comp.max()) + 1, -1, np.int32)
    remap[uniq_comp[np.argsort(first_point)]] = np.arange(
        len(uniq_comp), dtype=np.int32
    )
    labels[core] = remap[comp[core]]

    # border points: lowest-labelled core neighbor
    if border_pt_parts:
        bp = np.concatenate(border_pt_parts)
        bcr = np.concatenate(border_core_parts)
        cand = remap[comp[bcr]]
        best = np.full(n, np.iinfo(np.int32).max, np.int32)
        np.minimum.at(best, bp, cand)
        has = (best != np.iinfo(np.int32).max) & ~core
        labels[has] = best[has]
    return labels
