"""Convert parameters between the JAX package and the port.

The JAX side is its parameter pytree with numpy leaves (``jax.device_get``
of ``TrainState.params``), so this module needs no JAX:

  {"model": {"field": {"grid_table": (per-level [K_l, LO_l*16], ...),
                       "base_mlp": {...}, "color_mlp": {...},
                       "semantic_mlp": {...}, "semantic_head": {...},
                       "appearance": [N, A]},
             "proposal_networks": [{"mlp": {...}}, ...]},
   "camera_opt": [N, 6]}

The port's tree is the same except ``grid_table``, which is one flat table:

* cell mode: [sum T_l, 16]. A level's [K_l, LO_l*16] array is row-major
  [T_l, 16] (cell t at row t), so the conversion is a reshape and a
  concatenation.
* corner mode: [L*T, F]. The JAX table [L, 128, F*LO] holds entry
  t = hi*LO + lo at [l, hi, f*LO + lo]: its lanes are f-major, so the
  conversion transposes (as the JAX package's ``grid_encode_ref`` does).

A cell-v1 table of the JAX package's ``grid_encode_flat(mode="cell")``,
[L, 128, 16*CLO] with cell t = hi*CLO + lo at [l, hi, lo*16 + j], is
lo-major: a plain reshape to [L*T, 16] (``cell_v1_table_*``).
"""
from __future__ import annotations

import numpy as np
import torch

from .fields.encodings import GridEncodingConfig

HI = 128  # rows of the JAX package's per-level [128, ...] tiles


def tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in a canonical order: dicts by sorted key (as JAX orders a
    pytree), lists in order; so two trees of one structure line up however
    their dicts were built."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def grid_table_from_jax(levels, grid: GridEncodingConfig) -> np.ndarray:
    """Per-level [K_l, LO_l*16] arrays -> flat [sum T_l, 16] float32."""
    layout = grid.level_layout()
    if len(levels) != len(layout):
        raise ValueError(f"{len(levels)} level tables for {len(layout)} levels")
    rows = []
    for lvl, (t, (t_l, k_l, lo_l, _)) in enumerate(zip(levels, layout)):
        t = np.asarray(t, np.float32)
        if t.shape != (k_l, lo_l * 16):
            raise ValueError(
                f"level {lvl}: table {t.shape}, layout wants {(k_l, lo_l * 16)}"
            )
        rows.append(t.reshape(t_l, 16))
    return np.concatenate(rows, axis=0)


def grid_table_to_jax(table: np.ndarray, grid: GridEncodingConfig) -> tuple:
    """Flat [sum T_l, 16] -> per-level [K_l, LO_l*16] arrays."""
    layout = grid.level_layout()
    total = sum(t_l for t_l, _, _, _ in layout)
    if table.shape != (total, 16):
        raise ValueError(f"flat table {table.shape}, layout wants {(total, 16)}")
    out, start = [], 0
    for t_l, k_l, lo_l, _ in layout:
        out.append(table[start : start + t_l].reshape(k_l, lo_l * 16))
        start += t_l
    return tuple(out)


def corner_table_from_jax(table, table_size: int, features: int) -> np.ndarray:
    """[L, 128, F*LO] with f-major lanes -> flat [L*T, F] float32."""
    table = np.asarray(table, np.float32)
    lo = table_size // HI
    if table.ndim != 3 or table.shape[1:] != (HI, features * lo):
        raise ValueError(
            f"corner table {table.shape}, layout wants [L, {HI}, {features * lo}]"
        )
    num_levels = table.shape[0]
    t = table.reshape(num_levels, HI, features, lo).transpose(0, 1, 3, 2)
    return np.ascontiguousarray(t.reshape(num_levels * table_size, features))


def corner_table_to_jax(table: np.ndarray, table_size: int, features: int) -> np.ndarray:
    """Flat [L*T, F] -> [L, 128, F*LO] with f-major lanes."""
    lo = table_size // HI
    if table.ndim != 2 or table.shape[1] != features or table.shape[0] % table_size:
        raise ValueError(f"flat corner table {table.shape}, layout wants [L*{table_size}, {features}]")
    num_levels = table.shape[0] // table_size
    t = table.reshape(num_levels, HI, lo, features).transpose(0, 1, 3, 2)
    return np.ascontiguousarray(t.reshape(num_levels, HI, features * lo))


def cell_v1_table_from_jax(table) -> np.ndarray:
    """Cell v1 [L, 128, 16*CLO] (lo-major) -> flat [L*T, 16] float32."""
    table = np.asarray(table, np.float32)
    if table.ndim != 3 or table.shape[1] != HI or table.shape[2] % 16:
        raise ValueError(f"cell-v1 table {table.shape}, layout wants [L, {HI}, 16*CLO]")
    return table.reshape(-1, 16)


def cell_v1_table_to_jax(table: np.ndarray, table_size: int) -> np.ndarray:
    """Flat [L*T, 16] -> cell v1 [L, 128, 16*CLO]."""
    return table.reshape(-1, HI, 16 * (table_size // HI))


def table_from_jax(table, grid: GridEncodingConfig) -> np.ndarray:
    """The JAX package's grid table of either mode -> the port's flat table."""
    if grid.mode == "corner":
        return corner_table_from_jax(table, grid.table_size, grid.features_per_level)
    return grid_table_from_jax(table, grid)


def params_from_jax(tree: dict, grid: GridEncodingConfig, device) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's tensors on ``device``."""
    field = dict(tree["model"]["field"])
    field["grid_table"] = table_from_jax(field["grid_table"], grid)
    tree = {
        "model": {"field": field, "proposal_networks": tree["model"]["proposal_networks"]},
        "camera_opt": tree["camera_opt"],
    }
    return tree_map(
        tree,
        lambda a: torch.as_tensor(np.array(a, np.float32, copy=True), device=device),
    )


def params_to_jax(params: dict, grid: GridEncodingConfig) -> dict:
    """The port's parameters -> a JAX-layout tree with numpy leaves."""
    tree = tree_map(params, lambda t: t.detach().cpu().numpy())
    field = tree["model"]["field"]
    if grid.mode == "corner":
        field["grid_table"] = corner_table_to_jax(
            field["grid_table"], grid.table_size, grid.features_per_level
        )
    else:
        field["grid_table"] = grid_table_to_jax(field["grid_table"], grid)
    return tree
