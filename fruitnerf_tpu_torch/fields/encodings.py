"""Input encodings: the instant-ngp hash grid (``hash_encode``), the
multiresolution grid of the grid variant (cell and corner modes),
spherical harmonics, frequency. Twin of ``fruitnerf_tpu/fields/encodings.py``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.freq_encode import freq_encode
from ..ops.hash_grid import (
    CellLayout, cell_encode, cell_level_layout, corner_layout, grid_encode_flat,
    uniform_cell_layout,
)


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    """The instant-ngp hash grid: ``num_levels`` levels of one uniform table
    of 2^``log2_hashmap_size`` entries, resolutions ``base_res`` ..
    ``max_res``.

    ``mode="corner"``: instant-ngp semantics, 8 corner entries of F
    features per (point, level); direct when (res+1)^3 <= T, else hashed.
    ``mode="cell"`` (F = 2): each cell's 8 corners x F features in one
    16-float row; direct when res^3 <= T. The JAX package's ``[L, T,
    row_width]`` table is the port's flat ``[L*T, row_width]`` table."""

    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    mode: str = "corner"

    def __post_init__(self):
        if self.mode not in ("cell", "corner"):
            raise ValueError(
                f"HashEncodingConfig.mode must be 'cell' or 'corner'; got {self.mode!r}"
            )
        if self.mode == "cell" and self.features_per_level != 2:
            raise ValueError(
                "cell mode packs 8 corners x F=2 features into 16-float rows; "
                f"features_per_level must be 2, got {self.features_per_level}"
            )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def row_width(self) -> int:
        return self.features_per_level * (1 if self.mode == "corner" else 8)

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return math.exp(
            (math.log(self.max_res) - math.log(self.base_res))
            / (self.num_levels - 1)
        )

    def level_resolutions(self) -> list[int]:
        g = self.growth_factor
        return [
            int(math.floor(self.base_res * (g**lvl))) for lvl in range(self.num_levels)
        ]

    def table_layout(self) -> CellLayout:
        """Each level's T rows in the flat table and its direct flag."""
        if self.mode == "corner":
            return corner_layout(self.level_resolutions(), self.table_size)
        return uniform_cell_layout(self.level_resolutions(), self.table_size)

    @property
    def table_shape(self) -> tuple[int, int]:
        """[L*T, row_width]."""
        return (self.num_levels * self.table_size, self.row_width)


def init_hash_table(
    config: HashEncodingConfig, generator: torch.Generator, device
) -> torch.Tensor:
    """The flat table (``config.table_shape``), uniform(-1e-4, 1e-4) like
    instant-ngp."""
    u = torch.rand(config.table_shape, generator=generator, device=device)
    return u * 2e-4 - 1e-4


def hash_encode(
    table: torch.Tensor, positions: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """positions [..., 3] in [0,1)^3 -> features [..., L*F] float32.
    ``grid_encode_flat`` at one uniform T in either mode: the corner
    kernels (K3/K4) or, in cell mode, the cell kernels at
    ``uniform_cell_layout`` (K1/K2) on CUDA tensors; their plain versions
    on CPU tensors. Compute is float32 (the JAX twin casts the table to its
    compute dtype)."""
    batch_shape = positions.shape[:-1]
    out = grid_encode_flat(
        table, positions.reshape(-1, 3), config.level_resolutions(), config.table_size,
        config.features_per_level, config.mode,
    )
    return out.reshape(*batch_shape, config.out_dim)


@dataclasses.dataclass(frozen=True)
class GridEncodingConfig:
    """Multiresolution grid, instant-ngp levels.

    ``mode="cell"``: one 16-float row per cell (8 corners x 2 features);
    ``table_size`` caps each level's rows, and with ``mid_table_size`` set
    only the finest ``fine_levels`` levels get ``table_size`` rows and every
    earlier level is capped at ``mid_table_size``. ``radix`` only fixes the
    JAX package's ``[K_l, LO_l*16]`` array shapes, which the bridge converts.

    ``mode="corner"``: exact instant-ngp trilinear corner sharing, one
    uniform table of ``table_size`` rows x ``features_per_level`` a level."""

    num_levels: int = 16
    features_per_level: int = 2
    table_size: int = 8192
    base_res: int = 16
    max_res: int = 2048
    mid_table_size: int | None = None
    fine_levels: int = 4
    mode: str = "cell"
    radix: int = 512

    def __post_init__(self):
        t = self.table_size
        if t < 128 or (t & (t - 1)) != 0:
            raise ValueError(
                f"GridEncodingConfig.table_size must be a power of two >= 128 "
                f"(indices are resolved with bit masks); got {t}"
            )
        r = self.radix
        if r < 128 or (r & (r - 1)) != 0:
            raise ValueError(
                f"GridEncodingConfig.radix must be a power of two >= 128; got {r}"
            )
        m = self.mid_table_size
        if m is not None and (m < 128 or (m & (m - 1)) != 0):
            raise ValueError(
                f"GridEncodingConfig.mid_table_size must be a power of two "
                f">= 128; got {m}"
            )
        if m is not None and not (0 <= self.fine_levels <= self.num_levels):
            raise ValueError(
                f"GridEncodingConfig.fine_levels must be in "
                f"[0, num_levels]; got {self.fine_levels}"
            )
        if self.mode not in ("cell", "corner"):
            raise ValueError(
                f"GridEncodingConfig.mode must be 'cell' or 'corner'; got {self.mode!r}"
            )
        if m is not None and self.mode != "cell":
            raise ValueError(
                "GridEncodingConfig.mid_table_size (two-tier capacity) is "
                f"only implemented for mode='cell'; got mode={self.mode!r}"
            )
        if self.mode == "cell" and self.features_per_level != 2:
            raise ValueError(
                "cell mode packs 8 corners x F=2 features into 16-float rows; "
                f"features_per_level must be 2, got {self.features_per_level}"
            )

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return math.exp(
            (math.log(self.max_res) - math.log(self.base_res))
            / (self.num_levels - 1)
        )

    def level_resolutions(self) -> tuple[int, ...]:
        g = self.growth_factor
        return tuple(
            int(math.floor(self.base_res * (g**lvl)))
            for lvl in range(self.num_levels)
        )

    def level_caps(self):
        """``table_size`` when uniform, else a per-level tuple of caps."""
        if self.mid_table_size is None:
            return self.table_size
        cut = self.num_levels - self.fine_levels
        return tuple(
            self.table_size if lvl >= cut else self.mid_table_size
            for lvl in range(self.num_levels)
        )

    def level_layout(self):
        """Cell mode: per-level (T_l, K_l, LO_l, use_direct)."""
        return cell_level_layout(
            self.level_resolutions(), self.level_caps(), self.radix
        )

    def cell_layout(self) -> CellLayout:
        """Cell mode: where each level lives in the flat [sum T_l, 16] table."""
        return CellLayout.from_levels(self.level_resolutions(), self.level_layout())

    def table_layout(self) -> CellLayout:
        """Either mode: each level's rows and direct flag in the flat table."""
        if self.mode == "corner":
            return corner_layout(self.level_resolutions(), self.table_size)
        return self.cell_layout()

    @property
    def table_shape(self) -> tuple[int, int]:
        """[sum T_l, 16] in cell mode, [L*T, F] in corner mode."""
        width = self.features_per_level if self.mode == "corner" else 16
        return (self.table_layout().total_rows, width)


def init_grid_table(
    config: GridEncodingConfig, generator: torch.Generator, device
) -> torch.Tensor:
    """The flat table (``config.table_shape``), uniform(-1e-4, 1e-4) like
    instant-ngp."""
    u = torch.rand(config.table_shape, generator=generator, device=device)
    return u * 2e-4 - 1e-4


def grid_encode(
    table: torch.Tensor, positions: torch.Tensor, config: GridEncodingConfig
) -> torch.Tensor:
    """positions [..., 3] in [0,1]^3 -> features [..., L*F] float32. Cell
    mode runs ``cell_encode``; corner mode runs ``grid_encode_flat``, as the
    JAX package does."""
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    if config.mode == "cell":
        out = cell_encode(table, pos, config.cell_layout())
    else:
        out = grid_encode_flat(
            table, pos, config.level_resolutions(), config.table_size,
            config.features_per_level, config.mode,
        )
    return out.reshape(*batch_shape, config.out_dim)


def sh_encode(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH basis values for unit directions [..., 3] -> [..., levels**2]."""
    if not 1 <= levels <= 4:
        raise ValueError(f"sh_encode supports 1..4 levels, got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [0.28209479177387814 * torch.ones_like(x)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525252005,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


def nerf_encode(
    x: torch.Tensor, num_frequencies: int, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The input, then sin and cos at octave frequencies pi * 2^k:
    [..., D] -> [..., D + D*2*F], in the JAX twin's column order with
    ``include_input=True`` (input, all sines, all cosines; dim-major),
    computed in float32 and written in ``dtype`` (None: float32), the
    values ``.to(dtype)`` of the float32 encoding gives. CPU tensors take
    the plain composition; CUDA tensors the kernel pair of
    ``ops/freq_encode.py``."""
    return freq_encode(x, num_frequencies, dtype)
