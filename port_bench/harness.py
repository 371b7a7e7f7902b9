"""Finds a cell's pieces by name, from ``BENCHMARK.json`` and the data files
beside the harness: nothing here names a configuration, a traffic mix or a
metric.

* ``port_bench/configs/<config>.json``: the configuration (``configs[].file``
  in ``BENCHMARK.json``): preset, variant, overrides, source, ``reduced``,
  ``assumed`` and the whole ``config`` as it is run;
* ``port_bench/traffic/<traffic>.json``: the traffic mix, parameters that
  its entry reads (the entry's name, the scenes, the start step, the
  warm-up and checked steps, the traced steps, overrides of the config);
* ``port_bench/entries/<entry>.py``: the class ``Entry`` that drives the
  port through the window's own call and gives the cell's end-to-end
  values and its comparison with the reference (``training.py``);
* ``port_bench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
* ``port_bench/metrics/<metric>.py``: one reader a per-layer metric, a
  function ``read(ctx) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(ctx) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    entry: type  # the Entry class of entries/<traffic's entry>.py
    limits: dict  # {number: limit}
    end_to_end: list  # [(name, unit)]
    per_layer: list  # [Metric]


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root=None) -> dict:
    root = Path.cwd() if root is None else Path(root)
    return load_json(root / "BENCHMARK.json")


def _load(bench_dir: Path, folder: str, name: str):
    path = bench_dir / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(bench_dir, "metrics", name).read


def load_entry(name: str, bench_dir: Path = HERE) -> type:
    """The ``Entry`` class of ``entries/<name>.py``."""
    return _load(bench_dir, "entries", name).Entry


def cell(workload: str, root=None) -> Cell:
    """The cell ``workload`` of the benchmark at ``root`` (the working
    directory by default), with its files loaded."""
    root = Path.cwd() if root is None else Path(root)
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(w['name'] for w in bench['workloads'])}")
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / HERE.name  # the data files of the checkout at root
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=load_json(root / configs[entry["config"]]["file"]),
        traffic=traffic,
        entry=load_entry(traffic["entry"], here),
        limits=load_json(here / "limits" / f"{workload}.json"),
        end_to_end=[(m["name"], m["unit"]) for m in bench["end_to_end"]],
        per_layer=[Metric(m["name"], m["unit"], load_reader(m["name"], here))
                   for m in bench["per_layer"]],
    )


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid over it, dicts key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_config(c: Cell) -> dict:
    """The config a cell runs: the configuration's, with its traffic's
    overrides (for example the campaign's rays a scene and schedule)."""
    return merged(c.config["config"], c.traffic.get("config", {}))
