"""The port's benchmark: one run of one cell.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. It sets up
the cell (scene, weights and state from the seed, the kernels built into
``fruitnerf_tpu_torch/_build/`` on a checkout's first run), warms up,
trains for ``--seconds`` and, with ``--trace 1``, traces a second window
under ``torch.profiler``. It then frees the program's state, runs the
plain reference over the checked steps and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. Diagnostics go to
standard error; its last lines are the compared numbers.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), on any error, and when ``jax``, ``jaxlib``,
``flax``, ``optax`` or ``fruitnerf_tpu`` is among the loaded modules.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fruitnerf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``fruitnerf_tpu_torch`` is not ``fruitnerf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*parts):
    print("port_bench:", *parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def cpu_model() -> str:
    name = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("model name", "hardware")):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} cores"


def per_layer(cell, res, cfg: dict, ref, wall_s_per_step: float) -> dict:
    """{metric: value} of the cell's per-layer readers over the traced
    window; a reader that finds nothing returns None and is left out.
    ``ref``: what the entry's ``compare`` gave beside its numbers."""
    from . import metrics_context
    from .trace import grid_part

    work = cell.entry.least_work(res, cfg, ref)
    ctx = metrics_context.Context(
        trace=res.trace, work=work, steps=res.trace.steps,
        host_cpu_s_per_step=res.cpu_s / res.steps, wall_s_per_step=wall_s_per_step)
    by_op = sum(1 for e in res.trace.events
                if grid_part(dataclasses.replace(e, name="")) is not None)
    log(f"grid events: {sum(1 for e in res.trace.events if grid_part(e))} of "
        f"{len(res.trace.events)}, {by_op} of them told by their launching op")
    out = {}
    for m in cell.per_layer:
        v = m.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def main(argv=None, device=None, root=None, cfg_check=True) -> dict:
    """One run; returns the result line's object. Tests pass ``device`` (run
    there without looking for a card), ``root`` (a shrunk benchmark) and
    ``cfg_check=False`` (its configurations are not the port's presets)."""
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from . import check, drive, harness, trace as TR

    cell = harness.cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("port_bench: torch finds no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"port_bench: the cell asks for {cell.chips} cards, torch finds "
                             f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.init()
    else:
        dev = torch.device(device)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    cfg = harness.run_config(cell)
    res = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, T_START,
                         cfg_check=cfg_check, log=log)
    wall_per_step = res.window_s / max(res.steps, 1)
    values = {"setup_s": res.setup_s, **cell.entry.values(res)}
    log(f"cell {cell.name} seed {args.seed}: set-up {res.setup_s:.3f} s (kernel build "
        f"{res.build_s:.3f} s), window {res.window_s:.4f} s, {res.steps} steps, "
        f"{res.units} units, {values}, {wall_per_step * 1e3:.4f} ms/step wall, "
        f"{res.cpu_s / max(res.steps, 1) * 1e3:.4f} ms/step of process CPU, "
        f"peak {res.memory_peak_bytes / 2**30:.3f} GiB")

    t_ref = time.perf_counter()
    where: dict = {}
    nums, ref = cell.entry.compare(res, cfg, cell.traffic, dev, where)
    log(f"where each number is set: {where}")
    ok = check.verdict(nums, cell.limits) and res.finite
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")

    result = {"correct": bool(ok), "attempted": res.steps,
              "failed": 0 if res.finite else res.steps}
    if args.trace:
        if res.trace.busy_s() <= 0:
            raise RuntimeError("the traced window holds no device operation")
        # the host's rate over the untraced window: the profiler slows the host
        t_m = time.perf_counter()
        metrics = per_layer(cell, res, cfg, ref, wall_per_step)
        log(f"per-layer metrics: {time.perf_counter() - t_m:.3f} s; profile read in "
            f"{res.trace_read_s:.3f} s")
        result["metrics"] = metrics
        log(f"traced window: {res.trace.steps} steps in {res.trace.window_s:.4f} s, device "
            f"busy {res.trace.busy_s():.4f} s, {len(res.trace.events)} device events")
    else:
        result["metrics"] = {name: {"value": values[name], "unit": unit}
                             for name, unit in cell.end_to_end if name in values}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                        "count": cell.chips, "memory_peak_bytes": res.memory_peak_bytes}
    if args.trace:
        result["device"].update(busy_s=res.trace.busy_s(), window_s=res.trace.window_s)
        result["breakdown"] = TR.breakdown(res.trace)
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in nums.items()}
    if dev.type == "cuda":
        log(f"card: {card_line()}; host CPU: {cpu_model()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    for k, v in nums.items():
        print(f"check {k} {v!r} limit {cell.limits.get(k)!r}", file=sys.stderr, flush=True)
    return result


def _entry() -> int:
    os.environ.setdefault("USE_FLAX", "0")
    try:
        result = main()
    except SystemExit as e:
        if e.code not in (None, 0):
            print(e.code if isinstance(e.code, str) else f"exit {e.code}", file=sys.stderr)
            return 2
        raise
    except Exception:  # noqa: BLE001 - a run that fails prints its traceback and no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_entry())
