"""Checkpoints and the run manifest. Twin of
``fruitnerf_tpu/engine/checkpoints.py``.

A checkpoint is one ``ckpt_{step:09d}.pt`` file written with ``torch.save``:
the step, the parameters (as CPU tensors), the optimizer's ``state_dict()``
and the training loop's generator state, so that a resumed run draws what an
uninterrupted one would. It is written to a temporary file and renamed into
place, so a preempted save never leaves a partial latest checkpoint.

The manifest keeps the JAX package's JSON schema and adds a ``grid`` entry,
the resolved grid layout (mode, features, resolutions, per-level rows and
direct flags, caps): restoring rebuilds the table's shape from it and
refuses a config whose layout differs, so a changed default cannot leave an
older run unrestorable or silently reshaped. The JAX package's manifest
lacks it.

``read_jax_checkpoint`` reads a JAX ``ckpt_*.msgpack`` with ``msgpack``
alone and converts it through ``bridge.params_from_jax``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from ..bridge import params_from_jax, tree_leaves, tree_map
from ..fields.encodings import GridEncodingConfig

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def save_checkpoint(checkpoint_dir, state, generator: torch.Generator | None = None) -> Path:
    """Write ``state`` (and the loop's ``generator`` state) atomically;
    returns the checkpoint's path."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    payload = {
        "step": step,
        "params": tree_map(state.params, lambda t: t.detach().cpu()),
        "optimizer": state.optimizer.state_dict(),
        "generator": None if generator is None else generator.get_state(),
    }
    path = checkpoint_dir / f"ckpt_{step:09d}.pt"
    tmp = checkpoint_dir / f".tmp_ckpt_{step:09d}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)  # atomic: preemption-safe
    return path


def latest_checkpoint(checkpoint_dir) -> Path | None:
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.is_dir():
        return None
    best = None
    for p in checkpoint_dir.iterdir():
        m = _CKPT_RE.search(p.name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), p)
    return best[1] if best else None


def _shape_mismatches(template, restored, path: str, out: list[str]):
    if isinstance(template, dict) or isinstance(restored, dict):
        if not (isinstance(template, dict) and isinstance(restored, dict)):
            out.append(f"{path}: ckpt {type(restored).__name__} vs template {type(template).__name__}")
            return
        for k in sorted(set(template) | set(restored)):
            if k not in restored:
                out.append(f"{path}/{k}: missing in the checkpoint")
            elif k not in template:
                out.append(f"{path}/{k}: not in the template")
            else:
                _shape_mismatches(template[k], restored[k], f"{path}/{k}", out)
    elif isinstance(template, (list, tuple)):
        if not isinstance(restored, (list, tuple)) or len(restored) != len(template):
            n = len(restored) if isinstance(restored, (list, tuple)) else type(restored).__name__
            out.append(f"{path}: ckpt {n} entries vs template {len(template)}")
            return
        for i, (a, b) in enumerate(zip(template, restored)):
            _shape_mismatches(a, b, f"{path}/{i}", out)
    elif tuple(template.shape) != tuple(getattr(restored, "shape", ())):
        out.append(
            f"{path}: ckpt {tuple(getattr(restored, 'shape', ()))} vs template {tuple(template.shape)}"
        )


def load_checkpoint(path, target_state, generator: torch.Generator | None = None):
    """Restore into a template state (same structure, e.g. from
    ``init_train_state``), in place, and return it: parameters, the
    optimizer's state and the step; and the loop's generator state into
    ``generator`` when given. Every parameter's shape is checked against
    the template first; a mismatch raises ValueError naming the paths."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    mismatches: list[str] = []
    _shape_mismatches(target_state.params, ckpt["params"], "", mismatches)
    if mismatches:
        raise ValueError(
            f"checkpoint {path} does not match the model/config template:\n  "
            + "\n  ".join(mismatches[:10])
        )
    with torch.no_grad():
        for dst, src in zip(tree_leaves(target_state.params), tree_leaves(ckpt["params"])):
            dst.copy_(src)
    target_state.optimizer.load_state_dict(ckpt["optimizer"])
    target_state.step = int(ckpt["step"])
    if generator is not None and ckpt["generator"] is not None:
        generator.set_state(ckpt["generator"])
    return target_state


def resume_from_latest(checkpoint_dir, target_state, generator: torch.Generator | None = None):
    """-> (state, True) restored from the latest checkpoint, or
    (target_state, False) when there is none."""
    path = latest_checkpoint(checkpoint_dir)
    if path is None:
        return target_state, False
    return load_checkpoint(path, target_state, generator), True


def read_jax_checkpoint(path, grid: GridEncodingConfig, device) -> tuple[dict, int]:
    """A JAX ``ckpt_*.msgpack`` (``flax.serialization.to_bytes`` of its
    TrainState) -> (the port's parameters on ``device``, step). Decodes
    flax's msgpack format with ``msgpack`` alone: arrays are extension 1
    (ndarray) or 3 (numpy scalar), each a packed (shape, dtype name,
    row-major bytes); lists and tuples are dicts keyed "0", "1", ...."""
    import msgpack

    def ext_hook(code, data):
        if code not in (1, 3):
            return msgpack.ExtType(code, data)
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
        return arr if code == 1 else arr[()]

    def lists(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: lists(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out

    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return params_from_jax(lists(state["params"]), grid, device), int(state["step"])


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------


def _to_jsonable(x):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return np.asarray(x).tolist()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_jsonable(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


def grid_layout(grid: GridEncodingConfig) -> dict:
    """The manifest's ``grid`` entry: the config's fields and the layout
    they resolve to."""
    layout = grid.table_layout()
    caps = grid.level_caps()
    return {
        **_to_jsonable(grid),
        "resolutions": list(layout.resolutions),
        "rows": list(layout.rows),
        "direct": list(layout.direct),
        "caps": list(caps) if isinstance(caps, tuple) else [caps] * grid.num_levels,
        "table_shape": list(grid.table_shape),
    }


def grid_from_manifest(manifest: dict) -> GridEncodingConfig:
    """Rebuild the grid config a manifest records; raises ValueError (as
    ``check_grid``) when the rebuilt layout differs from the recorded one."""
    names = {f.name for f in dataclasses.fields(GridEncodingConfig)}
    grid = GridEncodingConfig(**{k: v for k, v in manifest["grid"].items() if k in names})
    check_grid(manifest, grid)
    return grid


def check_grid(manifest: dict, grid: GridEncodingConfig) -> None:
    """Refuse to restore a run whose recorded grid layout differs from
    ``grid``'s: raises ValueError naming the fields that differ."""
    want = grid_layout(grid)
    differ = sorted(k for k in want if manifest["grid"].get(k) != want[k])
    if differ:
        raise ValueError(
            "the run's grid layout does not match this config: "
            + ", ".join(f"{k} {manifest['grid'].get(k)!r} vs {want[k]!r}" for k in differ[:6])
        )


def write_manifest(
    run_dir,
    preset: str,
    dataparser_transform: np.ndarray,
    dataparser_scale: float,
    scene_aabb: np.ndarray,
    num_images: int,
    grid: GridEncodingConfig,
    semantics_classes=("apple", "stuff"),
    extra: dict | None = None,
) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    manifest = {
        "framework": "fruitnerf_tpu_torch",
        "preset": preset,
        "dataparser_transform": _to_jsonable(dataparser_transform),
        "dataparser_scale": float(dataparser_scale),
        "scene_aabb": _to_jsonable(scene_aabb),
        "num_images": int(num_images),
        "semantics_classes": list(semantics_classes),
        "grid": grid_layout(grid),
    }
    if extra:
        manifest.update(_to_jsonable(extra))
    path = run_dir / "manifest.json"
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def read_manifest(run_dir) -> dict:
    with open(Path(run_dir) / "manifest.json") as f:
        return json.load(f)
