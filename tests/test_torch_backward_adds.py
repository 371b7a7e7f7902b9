"""``ops/hash_grid.py:backward_adds`` (the runs and dTable adds of one K2/K4
launch, by the kernels' tiling) against a brute-force loop over tiles,
levels and lanes, in cell mode and in corner mode at F = 1, 2, 4: on random
points, on ray-ordered points (48 sorted samples a ray), and on points that
alternate in runs of three between two cells whose rows collide at the
finest level; P is no multiple of the 32-point tile and one point sits at
exactly 1.0, past the direct level's table. No JAX: the counter has no
twin there."""

import numpy as np
import pytest
import torch

from fruitnerf_tpu_torch.ops import hash_grid as hg

P1, P2, MASK = 2654435761, 805459861, 0xFFFFFFFF
T = 512
RES = {False: (8, 16, 64, 300), True: (7, 16, 64, 300)}  # level 0 direct, filling T
P = 32 * 9 + 13


def _layout(corner: bool):
    if corner:
        return hg.corner_layout(RES[True], T)
    return hg.CellLayout.from_levels(RES[False], hg.cell_level_layout(RES[False], T, 128))


def _row(ix, iy, iz, res, rows, direct, stride):
    """Row of integer point (ix, iy, iz) at a level, or None outside it."""
    if direct:
        idx = ix + iy * stride + iz * stride * stride
        return idx if 0 <= idx < rows else None
    h = (ix & MASK) ^ ((iy * P1) & MASK) ^ ((iz * P2) & MASK)
    return h & (rows - 1)


def _lines(run_rows: list, width: int) -> int:
    """Distinct (instruction, 128-byte line) pairs of a warp's staged adds:
    run r's rows run_rows[r] (None: no entry) of ``width`` entries each
    fill slots r * S .. r * S + S - 1, S = len(rows) * width, 32 slots an
    instruction."""
    seen = set()
    for r, rows in enumerate(run_rows):
        for j in range(len(rows) * width):
            row = rows[j // width]
            if row is not None:
                seen.add(((r * len(rows) * width + j) // 32, (row * width + j % width) // 16))
    return len(seen)


def _brute(pos: np.ndarray, layout, features: int, corner: bool) -> dict:
    runs = adds = lines = 0
    offsets = layout.offsets
    for lvl in range(layout.num_levels):
        res, rows, direct = layout.resolutions[lvl], layout.rows[lvl], layout.direct[lvl]
        cells = [tuple(int(c) for c in np.floor(p * np.float32(res))) for p in pos]
        for t0 in range(0, len(pos), 32):
            lanes = range(t0, min(t0 + 32, len(pos)))
            if corner:
                keys = [cells[i] for i in lanes]
            else:
                keys = [_row(*cells[i], res, rows, direct, res) for i in lanes]
            ends = []  # the flat rows of each adding run, in lane order
            for j, key in enumerate(keys):
                if j + 1 < len(keys) and keys[j + 1] == key:
                    continue  # not the run's last lane
                if corner:
                    ix, iy, iz = key
                    corners = [_row(ix + cx, iy + cy, iz + cz, res, rows, direct, res + 1)
                               for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]
                    flat = [None if c is None else offsets[lvl] + c for c in corners]
                    runs += 1
                    adds += features * sum(c is not None for c in corners)
                    ends.append(flat)
                elif key is not None:
                    runs, adds = runs + 1, adds + 16
                    ends.append([offsets[lvl] + key])
            if corner:  # pair k: corners k (cx = 0) and 4 + k (cx = 1)
                lines += sum(_lines([[e[k], e[4 + k]] for e in ends], features)
                             for k in range(4))
            else:
                lines += _lines(ends, 16)
    return {"runs": runs, "adds": adds, "modeled_l2_lines": lines}


def _colliding_cells(layout, corner: bool):
    """Two cells at the finest (hashed) level whose rows collide: in cell
    mode their own rows, in corner mode their corner-0 entries'."""
    res, rows = layout.resolutions[-1], layout.rows[-1]
    assert not layout.direct[-1]
    rng = np.random.default_rng(3)
    seen = {}
    while True:
        c = tuple(int(v) for v in rng.integers(0, res - 1, 3))
        r = _row(*c, res, rows, False, res)
        if r in seen and seen[r] != c:
            return seen[r], c
        seen[r] = c


def _points(kind: str, layout, corner: bool) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "random":
        pos = rng.random((P, 3), dtype=np.float32)
    elif kind == "ray_ordered":
        rays = -(-P // 48)
        origin = 0.2 + 0.6 * rng.random((rays, 1, 3))
        d = rng.normal(size=(rays, 1, 3))
        t = np.sort(rng.random((rays, 48, 1)), axis=1)
        pos = (origin + 0.3 * t * d / np.linalg.norm(d, axis=-1, keepdims=True))
        pos = np.clip(pos, 0.0, 0.999).reshape(-1, 3)[:P].astype(np.float32)
    else:
        a, b = _colliding_cells(layout, corner)
        cell = np.array([a, b], dtype=np.float64)[(np.arange(P) // 3) % 2]
        pos = ((cell + 0.1 + 0.8 * rng.random((P, 3))) / layout.resolutions[-1])
        pos = pos.astype(np.float32)
    pos[5] = (0.5, 0.5, 1.0)  # past level 0's rows (cell) or its +z corners (corner)
    return pos


@pytest.mark.parametrize("kind", ["random", "ray_ordered", "collision"])
@pytest.mark.parametrize("mode", ["cell", "corner F=1", "corner F=2", "corner F=4"])
def test_backward_adds_match_a_brute_force_count(mode, kind):
    corner = mode != "cell"
    features = int(mode[-1]) if corner else 2
    layout = _layout(corner)
    assert layout.direct[0] and not layout.direct[-1] and layout.rows[0] == T
    pos = _points(kind, layout, corner)
    assert pos.shape[0] % 32 != 0
    got = hg.backward_adds(torch.from_numpy(pos), layout, features, corner)
    want = _brute(pos, layout, features, corner)
    assert got == want
    terms = P * layout.num_levels * (8 * features if corner else 16)
    assert 0 < got["adds"] < terms  # the 1.0 point drops adds; runs merge the rest
    # a cell run's row is one 128-byte line and a corner row (F = 1, 2, 4)
    # lies in one, which it may share with the other rows of its instruction
    assert 0 < got["modeled_l2_lines"] <= (got["adds"] // features if corner else got["runs"])
    coarse = hg.CellLayout(layout.resolutions[:1], layout.rows[:1], layout.direct[:1])
    one = hg.backward_adds(torch.from_numpy(pos[5:6]), coarse, features, corner)
    assert (one["runs"], one["adds"]) == ((1, 4 * features) if corner else (0, 0))
    if kind == "collision":
        # at the finest level a cell run (one row) takes both colliding
        # cells: a run a tile, and the 1.0 point splits tile 0 in three;
        # a corner run (one cell) stops at every change of cell
        fine = hg.CellLayout(layout.resolutions[-1:], layout.rows[-1:], layout.direct[-1:])
        runs = hg.backward_adds(torch.from_numpy(pos), fine, features, corner)["runs"]
        assert runs >= P // 3 if corner else runs == -(-P // 32) + 2
