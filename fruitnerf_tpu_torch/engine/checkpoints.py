"""Checkpoints and the run manifest. Twin of
``fruitnerf_tpu/engine/checkpoints.py``.

A checkpoint is one ``ckpt_{step:09d}.pt`` file written with ``torch.save``:
the step, the parameters (as CPU tensors), the optimizer's ``state_dict()``
and the training loop's generator state, so that a resumed run draws what an
uninterrupted one would. It is written to a temporary file and renamed into
place, so a preempted save never leaves a partial latest checkpoint.
``save_checkpoint_async`` copies all of it to host memory before it
returns (the train step updates parameters and moments in place) and
writes it on a worker thread.

The manifest keeps the JAX package's JSON schema and adds the field's
encoding and its resolved layout: a ``grid`` entry for the grid variant
(mode, features, resolutions, per-level rows and direct flags, caps), a
``hash`` entry for a hash field (the ``HashEncodingConfig`` fields, the
resolutions, rows and direct flags), or ``"table": null`` for a field with
no table (the frequency encoding). Restoring rebuilds the table's shape
from it and refuses a config whose encoding or layout differs, so a changed
default cannot leave an older run unrestorable or silently reshaped. The
JAX package's manifest lacks both.

``read_jax_checkpoint`` reads a JAX ``ckpt_*.msgpack`` with ``msgpack``
alone and converts it through ``bridge.params_from_jax``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from ..bridge import params_from_jax, tree_leaves
from ..fields.encodings import GridEncodingConfig, HashEncodingConfig

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def _host_copy(tree):
    """A copy of a state dict's nested dicts and lists, every tensor copied
    to host memory (a synchronous copy: the source may change next)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _snapshot(state, generator: torch.Generator | None) -> dict:
    return {
        "step": int(state.step),
        "params": _host_copy(state.params),
        "optimizer": _host_copy(state.optimizer.state_dict()),
        "generator": None if generator is None else generator.get_state(),
    }


def _write(checkpoint_dir: Path, payload: dict) -> Path:
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    step = payload["step"]
    path = checkpoint_dir / f"ckpt_{step:09d}.pt"
    tmp = checkpoint_dir / f".tmp_ckpt_{step:09d}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)  # atomic: preemption-safe
    return path


def save_checkpoint(checkpoint_dir, state, generator: torch.Generator | None = None) -> Path:
    """Write ``state`` (and the loop's ``generator`` state) atomically;
    returns the checkpoint's path."""
    return _write(Path(checkpoint_dir), _snapshot(state, generator))


def save_checkpoint_async(
    checkpoint_dir, state, generator: torch.Generator | None,
    executor: concurrent.futures.Executor,
) -> concurrent.futures.Future:
    """Copy ``state`` and the generator's state to host memory now, then
    write them on ``executor`` (one worker keeps the writes in order), as
    ``save_checkpoint`` does. The future's result is the path; read it to
    wait for the write and to raise its error."""
    return executor.submit(_write, Path(checkpoint_dir), _snapshot(state, generator))


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


def read_jax_checkpoint(path, model, device) -> tuple[dict, int]:
    """A JAX ``ckpt_*.msgpack`` (``flax.serialization.to_bytes`` of its
    TrainState) -> (the port's parameters on ``device``, step). Decodes
    flax's msgpack format with ``msgpack`` alone: arrays are extension 1
    (ndarray) or 3 (numpy scalar), each a packed (shape, dtype name,
    row-major bytes); lists and tuples are dicts keyed "0", "1", ....
    ``model`` is the run's ``FruitModelConfig``, which lays out its tables."""
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
    return params_from_jax(lists(state["params"]), model, device), int(state["step"])


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


_ENCODINGS = {"grid": GridEncodingConfig, "hash": HashEncodingConfig}


def _entry(encoding: GridEncodingConfig | HashEncodingConfig) -> str:
    return "hash" if isinstance(encoding, HashEncodingConfig) else "grid"


def grid_layout(encoding: GridEncodingConfig | HashEncodingConfig) -> dict:
    """The manifest's ``grid`` or ``hash`` entry: the config's fields and
    the layout they resolve to (a grid entry also records its caps)."""
    layout = encoding.table_layout()
    out = {
        **_to_jsonable(encoding),
        "resolutions": list(layout.resolutions),
        "rows": list(layout.rows),
        "direct": list(layout.direct),
        "table_shape": list(encoding.table_shape),
    }
    if isinstance(encoding, GridEncodingConfig):
        caps = encoding.level_caps()
        out["caps"] = list(caps) if isinstance(caps, tuple) else [caps] * encoding.num_levels
    return out


def grid_from_manifest(
    manifest: dict, expect: GridEncodingConfig | HashEncodingConfig | None = None
) -> GridEncodingConfig | HashEncodingConfig:
    """Rebuild the encoding config a manifest records (its ``grid`` or
    ``hash`` entry). Raises ValueError naming what differs when the rebuilt
    layout differs from the recorded one, or when ``expect`` (the field's
    encoding config about to restore the run) is of the other kind or has
    another layout."""
    kinds = [k for k in _ENCODINGS if k in manifest]
    if not kinds and "table" in manifest:
        theirs = "" if expect is None else f"; this config's encodes with {_entry(expect)!r}"
        raise ValueError(f"the run's field has no table (the frequency encoding){theirs}")
    if not kinds:
        raise ValueError(
            "the manifest has no grid entry, nor a hash entry (the JAX package's "
            "manifests lack both)"
        )
    kind = kinds[0]
    if expect is not None and _entry(expect) != kind:
        raise ValueError(
            f"the run's field encodes with {kind!r}, this config's with {_entry(expect)!r}"
        )
    recorded = manifest[kind]
    cls = _ENCODINGS[kind]
    names = {f.name for f in dataclasses.fields(cls)}
    encoding = cls(**{k: v for k, v in recorded.items() if k in names})
    for other in (encoding,) if expect is None else (encoding, expect):
        want = grid_layout(other)
        differ = sorted(k for k in want if recorded.get(k) != want[k])
        if differ:
            raise ValueError(
                f"the run's {kind} layout does not match this config: "
                + ", ".join(f"{k} {recorded.get(k)!r} vs {want[k]!r}" for k in differ[:6])
            )
    return encoding


def table_from_manifest(manifest: dict, field) -> GridEncodingConfig | HashEncodingConfig | None:
    """The table layout a manifest records, checked against ``field`` (the
    ``FruitFieldConfig`` about to restore the run) as ``grid_from_manifest``
    checks it; None for a field with no table, whose manifest must record
    none."""
    expect = field.encoding_config
    if expect is not None:
        return grid_from_manifest(manifest, expect=expect)
    recorded = [k for k in _ENCODINGS if k in manifest]
    if recorded or "table" not in manifest or manifest["table"] is not None:
        raise ValueError(
            f"this config's field ({field.encoding!r}) has no table; the manifest records "
            + (f"a {recorded[0]!r} table" if recorded else "no 'table': null entry")
        )
    return None


def write_manifest(
    run_dir,
    preset: str,
    dataparser_transform: np.ndarray,
    dataparser_scale: float,
    scene_aabb: np.ndarray,
    num_images: int,
    grid: GridEncodingConfig | HashEncodingConfig | None,
    semantics_classes=("apple", "stuff"),
    extra: dict | None = None,
) -> Path:
    """Write ``manifest.json``; ``grid`` is the field's encoding config
    (``FruitFieldConfig.encoding_config``), recorded under ``grid`` or
    ``hash``, or None for a field with no table (``"table": null``)."""
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
    }
    if grid is None:
        manifest["table"] = None
    else:
        manifest[_entry(grid)] = grid_layout(grid)
    if extra:
        manifest.update(_to_jsonable(extra))
    path = run_dir / "manifest.json"
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def read_manifest(run_dir) -> dict:
    with open(Path(run_dir) / "manifest.json") as f:
        return json.load(f)
