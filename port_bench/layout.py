"""Where each level of a grid encoding lives in its flat table, and the
index arithmetic that finds a position's rows: the yardstick's own copy.

Frozen copy of ``fruitnerf_tpu_torch/ops/hash_grid.py`` (``_pow2ceil``,
``cell_level_layout``, ``CellLayout``, ``corner_layout``,
``_hash_or_direct``, the corner bits) and of the level arithmetic of
``fruitnerf_tpu_torch/fields/encodings.py`` (``level_resolutions``,
``level_caps``), as of the benchmark's first version. The counts and the
plain reference use it; the port never imports it, and it imports nothing
of the port.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# instant-ngp spatial hash primes (uint32)
P1 = 2654435761
P2 = 805459861
MASK32 = 0xFFFFFFFF
# corner bits of c = 4cx + 2cy + cz
CX = (0, 0, 0, 0, 1, 1, 1, 1)
CY = (0, 0, 1, 1, 0, 0, 1, 1)
CZ = (0, 1, 0, 1, 0, 1, 0, 1)


def pow2ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class Layout:
    """Each level's resolution, rows T_l and whether its index is direct
    (else hashed), in one flat table; ``width`` floats a row (16 for a
    cell row of 8 corners x 2 features, F for a corner entry)."""

    resolutions: tuple[int, ...]
    rows: tuple[int, ...]
    direct: tuple[bool, ...]
    width: int
    corner: bool

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for t in self.rows:
            out.append(acc)
            acc += t
        return tuple(out)

    @property
    def total_rows(self) -> int:
        return sum(self.rows)

    @property
    def features(self) -> int:
        return self.width if self.corner else 2


def level_resolutions(base_res: int, max_res: int, num_levels: int) -> tuple[int, ...]:
    if num_levels == 1:
        g = 1.0
    else:
        g = math.exp((math.log(max_res) - math.log(base_res)) / (num_levels - 1))
    return tuple(int(math.floor(base_res * (g**lvl))) for lvl in range(num_levels))


def cell_layout(resolutions, caps) -> Layout:
    """Cell mode: T_l = max(128, min(cap_l, pow2ceil(res^3))), direct when
    the dense cell grid fits."""
    rows, direct = [], []
    for res, cap in zip(resolutions, caps):
        cells = int(res) ** 3
        t_l = max(128, min(int(cap), pow2ceil(cells)))
        rows.append(t_l)
        direct.append(cells <= t_l)
    return Layout(tuple(int(r) for r in resolutions), tuple(rows), tuple(direct), 16, False)


def corner_layout(resolutions, table_size: int, features: int) -> Layout:
    """Corner mode: T entries a level, direct with stride res+1 when the
    (res+1)^3 corners fit."""
    res = tuple(int(r) for r in resolutions)
    t = int(table_size)
    return Layout(res, (t,) * len(res), tuple((r + 1) ** 3 <= t for r in res), features, True)


def encoding_layout(enc: dict) -> Layout:
    """The layout of an encoding as a configuration file states it: a
    ``grid`` spec (cell mode, one cap or the two-tier caps) or a ``hash``
    spec (corner mode at 2^log2_hashmap_size, or cell mode at that T)."""
    levels = enc["num_levels"]
    res = level_resolutions(enc["base_res"], enc["max_res"], levels)
    if "log2_hashmap_size" in enc:  # a hash encoding
        t = 1 << enc["log2_hashmap_size"]
        if enc["mode"] == "corner":
            return corner_layout(res, t, enc["features_per_level"])
        return Layout(res, (t,) * levels, tuple(r**3 <= t for r in res), 16, False)
    if enc["mode"] != "cell":
        return corner_layout(res, enc["table_size"], enc["features_per_level"])
    mid = enc.get("mid_table_size")
    if mid is None:
        caps = (enc["table_size"],) * levels
    else:
        cut = levels - enc["fine_levels"]
        caps = tuple(enc["table_size"] if lvl >= cut else mid for lvl in range(levels))
    return cell_layout(res, caps)


def level_rows(ix, iy, iz, res: int, layout: Layout, level: int):
    """Integer coordinates (int64, any shape) at one level -> (flat row
    index, valid): direct ``ix + iy*stride + iz*stride^2`` (stride res+1 for
    corners, res for cells) or the instant-ngp hash masked to 32 bits, then
    ``& (T_l - 1)``; an index outside [0, T_l) is invalid and clamped."""
    t = layout.rows[level]
    stride = res + 1 if layout.corner else res
    if layout.direct[level]:
        idx = ix + iy * stride + iz * stride * stride
    else:
        idx = (ix ^ ((iy * P1) & MASK32) ^ ((iz * P2) & MASK32)) & (t - 1)
    valid = (idx >= 0) & (idx < t)
    return layout.offsets[level] + idx.clamp(0, t - 1), valid


def lookups(pos: torch.Tensor, layout: Layout, level: int):
    """positions [P, 3] in [0,1]^3 at one level -> (rows [P] or [P, 8],
    valid, fractions [P, 3]): a cell row, or the cell's 8 corner entries."""
    res = layout.resolutions[level]
    s = pos.float() * float(res)
    cell = torch.floor(s)
    frac = s - cell
    c = cell.long()
    if layout.corner:
        bits = torch.tensor((CX, CY, CZ), dtype=torch.int64, device=pos.device)  # [3, 8]
        ix, iy, iz = (c[:, :, None] + bits).unbind(1)  # [P, 8]
    else:
        ix, iy, iz = c.unbind(-1)
    rows, valid = level_rows(ix, iy, iz, res, layout, level)
    return rows, valid, frac
