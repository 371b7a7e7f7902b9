"""Convert parameters between the JAX package and the port.

The JAX side is its parameter pytree with numpy leaves (``jax.device_get``
of ``TrainState.params``), so this module needs no JAX:

  {"model": {"field": {"grid_table": (per-level [K_l, LO_l*16], ...),
                       "base_mlp": {...}, "color_mlp": {...},
                       "semantic_mlp": {...}, "semantic_head": {...},
                       "appearance": [N, A]},
             "proposal_networks": [{"mlp": {...}}, ...]},
   "camera_opt": [N, 6]}

with ``hash_table`` [L, T, row_width] in place of ``grid_table`` on a hash
field, no table on a frequency field (the ``tpu`` variant), and
``{"hash_table", "mlp"}`` for each hash DensityField proposal.
The port's tree is the same except its tables, each one flat table:

* every ``hash_table``: [L*T, row_width], the row-major reshape of
  [L, T, row_width] (row_width F in corner mode, 16 in cell mode);

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

from .fields.density_field import DensityFieldConfig
from .fields.encodings import GridEncodingConfig, HashEncodingConfig

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


def hash_table_from_jax(table, config: HashEncodingConfig) -> np.ndarray:
    """[L, T, row_width] -> flat [L*T, row_width] float32."""
    table = np.asarray(table, np.float32)
    want = (config.num_levels, config.table_size, config.row_width)
    if table.shape != want:
        raise ValueError(f"hash table {table.shape}, layout wants {list(want)}")
    return table.reshape(config.table_shape)


def hash_table_to_jax(table: np.ndarray, config: HashEncodingConfig) -> np.ndarray:
    """Flat [L*T, row_width] -> [L, T, row_width]."""
    if table.shape != config.table_shape:
        raise ValueError(f"flat hash table {table.shape}, layout wants {list(config.table_shape)}")
    return table.reshape(config.num_levels, config.table_size, config.row_width)


def _convert_tables(model: dict, config, hash_fn, grid_fn) -> dict:
    """A copy of the model tree (``{"field", "proposal_networks"}``) with
    every table converted: the field's by ``config.field``'s encoding (a
    frequency field has none), each hash proposal's by its
    ``DensityFieldConfig``."""
    field = dict(model["field"])
    key = config.field.table_key
    if config.field.encoding == "hash":
        field[key] = hash_fn(field[key], config.field.hash)
    elif config.field.encoding == "grid":
        field[key] = grid_fn(field[key], config.field.grid)
    nets = model["proposal_networks"]
    if len(nets) != len(config.proposal_nets):
        raise ValueError(f"{len(nets)} proposal networks for {len(config.proposal_nets)} configs")
    props = []
    for net, cfg in zip(nets, config.proposal_nets):
        net = dict(net)
        if isinstance(cfg, DensityFieldConfig):
            net["hash_table"] = hash_fn(net["hash_table"], cfg.hash)
        props.append(net)
    return {"field": field, "proposal_networks": props}


def _grid_table_to_jax(table: np.ndarray, grid: GridEncodingConfig):
    if grid.mode == "corner":
        return corner_table_to_jax(table, grid.table_size, grid.features_per_level)
    return grid_table_to_jax(table, grid)


def params_from_jax(tree: dict, model, device) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's tensors on ``device``.
    ``model`` is the run's ``FruitModelConfig``: it says each table's
    encoding and layout."""
    tree = {
        "model": _convert_tables(tree["model"], model, hash_table_from_jax, table_from_jax),
        "camera_opt": tree["camera_opt"],
    }
    return tree_map(
        tree,
        lambda a: torch.as_tensor(np.array(a, np.float32, copy=True), device=device),
    )


def params_to_jax(params: dict, model) -> dict:
    """The port's parameters -> a JAX-layout tree with numpy leaves."""
    tree = tree_map(params, lambda t: t.detach().cpu().numpy())
    tree["model"] = _convert_tables(tree["model"], model, hash_table_to_jax, _grid_table_to_jax)
    return tree


def zip_trees(trees: list, fn):
    """Trees of one structure -> one tree whose leaves are ``fn`` of the
    list of theirs."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: zip_trees([t[k] for t in trees], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return [zip_trees(list(xs), fn) for xs in zip(*trees)]
    return fn(trees)


def stack_trees(trees: list):
    """Trees of one structure -> one tree whose leaves (tensors or arrays)
    stack theirs on a new leading axis, the scene axis."""
    return zip_trees(trees, lambda xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor)
                     else np.stack([np.asarray(x) for x in xs]))


def index_tree(tree, s: int):
    """Scene ``s`` of a stacked tree (views of its leaves)."""
    return tree_map(tree, lambda t: t[s])


def scene_params_from_jax(tree: dict, model, device) -> dict:
    """The parameters of a JAX multi-scene state (leaves [S, ...], as
    ``init_multi_scene_state`` stacks them) -> the port's, stacked alike."""
    num_scenes = len(tree["camera_opt"])
    return stack_trees([params_from_jax(index_tree(tree, s), model, device)
                        for s in range(num_scenes)])


def scene_params_to_jax(params: dict, model) -> dict:
    """The port's stacked parameters -> a JAX-layout multi-scene tree with
    numpy leaves [S, ...]."""
    num_scenes = params["camera_opt"].shape[0]
    return stack_trees([params_to_jax(index_tree(params, s), model)
                        for s in range(num_scenes)])
