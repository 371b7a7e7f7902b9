"""The general driver: builds a cell's inputs from the seed, hands them to the
port through the cell's entry (``entries/<entry>.py``, named by the traffic
file), warms up through the window's own call, measures the window, traces
a second window on request, and keeps what the comparison with the
reference needs.

Set-up runs the first ``warmup_steps`` steps through the same call; the
entry records the first ``checked_steps`` of them for the reference. The
window is every step from its first to the ``torch.cuda.synchronize()``
after its last, on the host's clock.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from . import harness, scene as SC


def seeds(seed: int) -> dict:
    """Independent seeds of a run's parts, from ``--seed``."""
    parts = ("scene", "weights", "draws")
    ss = np.random.SeedSequence(int(seed)).spawn(len(parts))
    return {p: int(s.generate_state(1, np.uint32)[0]) for p, s in zip(parts, ss)}


def scene_params(traffic: dict, base_seed: int) -> list[dict]:
    """Each scene's orchard parameters; scene s has ``fruit_step`` more
    fruits and its seed ``seed_step`` on (``scene_configs``)."""
    sc = traffic["scene"]
    return [SC.orchard(sc["num_fruits"] + s * sc.get("fruit_step", 0), sc["num_cameras"],
                       sc["image_size"], base_seed + s * sc.get("seed_step", 0))
            for s in range(traffic.get("scenes", 1))]


def train_indices_for(num_images: int, train_fraction: float) -> np.ndarray:
    """Evenly spaced training cameras (frozen copy of the port's
    ``data/builder.py:train_indices_for``)."""
    num_train = max(1, int(np.ceil(num_images * train_fraction)))
    if num_train >= num_images:
        return np.arange(num_images)
    return np.unique(np.linspace(0, num_images - 1, num_train, dtype=np.int64))


def subsample(idx: np.ndarray, max_images) -> np.ndarray:
    """At most ``max_images`` of ``idx``, evenly spaced (frozen copy of
    ``subsample_train_images``' rule)."""
    if max_images is None or len(idx) <= max_images:
        return idx
    keep = np.unique(np.linspace(0, len(idx) - 1, max_images, dtype=np.int64))
    return idx[keep]


def split_of(cfg: dict, traffic: dict) -> float:
    f = traffic.get("train_fraction")
    return cfg["train_split_fraction"] if f is None else f


# ---------------------------------------------------------------------------
# the program's config, checked against the configuration file
# ---------------------------------------------------------------------------


def _spec_value(cur, val):
    if isinstance(cur, torch.dtype):
        return getattr(torch, val)
    if isinstance(cur, tuple) and not any(dataclasses.is_dataclass(c) for c in cur):
        return tuple(val)
    return val


def config_diff(obj, spec: dict, path: str = "") -> list[str]:
    """Paths where the program's config ``obj`` differs from ``spec``."""
    out = []
    for k, v in spec.items():
        if k == "kind":
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            out += config_diff(cur, v, f"{path}.{k}")
        elif isinstance(cur, tuple) and cur and dataclasses.is_dataclass(cur[0]):
            if len(cur) != len(v):
                out.append(f"{path}.{k}")
            else:
                for i, (c, s) in enumerate(zip(cur, v)):
                    out += config_diff(c, s, f"{path}.{k}[{i}]")
        elif cur != _spec_value(cur, v):
            out.append(f"{path}.{k}: program {cur!r}, configuration {v!r}")
    return out


def config_apply(obj, spec: dict):
    """``obj`` with every value of ``spec`` set (dataclasses, recursively)."""
    changes = {}
    for k, v in spec.items():
        if k == "kind":
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            changes[k] = config_apply(cur, v)
        elif isinstance(cur, tuple) and cur and dataclasses.is_dataclass(cur[0]):
            changes[k] = tuple(config_apply(c, s) for c, s in zip(cur, v))
        else:
            changes[k] = _spec_value(cur, v)
    return dataclasses.replace(obj, **changes)


def program_config(cell: harness.Cell, num_images: int, strict: bool = True):
    """The port's TrainConfig of the cell: the preset, variant and
    overrides the configuration file names, which must equal the file's
    ``config`` (``strict``), with the traffic's overrides applied."""
    from fruitnerf_tpu_torch.configs import apply_overrides, get_preset

    c = cell.config
    cfg = apply_overrides(get_preset(c["preset"], num_images, variant=c["variant"]),
                          c.get("overrides", {}))
    diff = config_diff(cfg, c["config"])
    if diff and strict:
        raise ValueError(f"the port's {c['preset']} {c['variant']} preset is not the "
                         f"configuration {c['name']}: " + "; ".join(diff))
    return config_apply(cfg, harness.run_config(cell))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
    setup_s: float
    window_s: float
    steps: int
    units: int  # what the window did: steps times the entry's units_per_step
    cpu_s: float
    finite: bool  # the entry's last output is finite
    build_s: float
    memory_peak_bytes: int
    checked: object  # the entry's record of the checked steps
    trace: object = None  # trace.Trace
    trace_first_step: int = 0
    trace_read_s: float = 0.0
    info: dict = dataclasses.field(default_factory=dict)  # the entry's describe()
    inputs: dict = dataclasses.field(default_factory=dict)  # the scenes and seeds made


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, cfg_check: bool = True, log=lambda *a: None) -> Result:
    """Set up, warm up, measure ``seconds``, and with ``trace`` measure a
    traced window of the traffic's ``trace_steps`` after it. ``t_start``:
    the host clock at the process's start."""
    from fruitnerf_tpu_torch.ops import hash_grid as hg

    t = cell.traffic
    parts = seeds(seed)
    build_s = 0.0
    if dev.type == "cuda":
        build_s = hg.build_kernels().seconds
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"kernels ready at {time.perf_counter() - t_start:.3f} s (build {build_s:.3f} s)")
    entry = cell.entry(cell, parts, dev, cfg_check)
    log(f"scene, data and state ready at {time.perf_counter() - t_start:.3f} s")

    def after(n):
        start = entry.step
        return lambda: entry.step - start >= n

    entry.run(entry.record, after(t["warmup_steps"]))
    _sync(dev)
    log(f"{t['warmup_steps']} warm-up steps done at {time.perf_counter() - t_start:.3f} s")
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    c0 = time.process_time()
    s0 = entry.step
    deadline = t0 + seconds
    stamps = []
    observe = entry.observe

    def stamp(state, metrics):
        observe(state, metrics)
        stamps.append(time.perf_counter())

    entry.run(stamp, lambda: time.perf_counter() >= deadline)
    _sync(dev)
    window_s = time.perf_counter() - t0
    fifths = [sum(1 for x in stamps if t0 + k * seconds / 5 <= x < t0 + (k + 1) * seconds / 5)
              for k in range(5)]
    log(f"steps issued in each fifth of the window: {fifths}")
    cpu_s = time.process_time() - c0
    steps = entry.step - s0
    res = Result(setup_s, window_s, steps, steps * entry.units_per_step, cpu_s, entry.finite(),
                 build_s, 0, entry.checked)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from . import trace as TR

        n = t["trace_steps"]
        res.trace_first_step = entry.step
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        log(f"tracing {n} steps")
        with profile(activities=acts) as prof:
            tt = time.perf_counter()
            entry.run(lambda s, m: None, after(n))
            _sync(dev)
            traced_s = time.perf_counter() - tt
        log(f"traced window done: {traced_s:.3f} s")
        tr = time.perf_counter()
        res.trace = TR.from_profile(prof, n, traced_s)
        res.trace_read_s = time.perf_counter() - tr
    if dev.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    res.info = entry.describe()
    res.inputs = entry.inputs()
    entry.close()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res
