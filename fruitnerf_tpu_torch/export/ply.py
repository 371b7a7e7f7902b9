"""Minimal binary PLY point-cloud IO (pure Python + numpy).

Replaces the reference's Open3D read/write (exporter.py:29,119;
clustering_base.py point-cloud IO). Supports binary_little_endian and ascii,
xyz + optional rgb(a) float/uchar colors — the subset the pipeline produces
and the counting stage consumes. The port's copy of
``fruitnerf_tpu/export/ply.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
}


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None) -> Path:
    """points [N,3] float; colors [N,3|4] in [0,1] floats or uint8."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
        names = ["red", "green", "blue", "alpha"][: colors.shape[1]]
        header += [f"property uchar {c}" for c in names]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            rec = np.zeros(
                n,
                dtype=[("xyz", "<f4", 3), ("rgb", "u1", colors.shape[1])],
            )
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
    return path


def read_ply(path) -> dict:
    """Returns {"points": [N,3] f32, "colors": [N,C] u8 or None}."""
    with open(path, "rb") as f:
        # header
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties not supported for vertices")
                props.append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        if n is None:
            raise ValueError(f"{path}: no vertex element")

        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, len(props))
            arr = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, _DTYPES[t]) for name, t in props])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            arr = {name: raw[name] for name in names}
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")

    points = np.stack(
        [arr["x"], arr["y"], arr["z"]], axis=-1
    ).astype(np.float32)
    color_names = [c for c in ("red", "green", "blue", "alpha") if c in arr]
    colors = (
        np.stack([np.asarray(arr[c]) for c in color_names], axis=-1)
        if color_names
        else None
    )
    if colors is not None and colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    return {"points": points, "colors": colors}
