"""The harness finds every piece by name; the counts equal hand counts; no
JAX is imported, and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import counts, drive, harness, layout as LY
from port_bench.run import FORBIDDEN

from .tiny import REPO, workloads

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", workloads())
def test_cell_found_by_name(workload):
    c = harness.cell(workload, REPO)
    entry = {w["name"]: w for w in BENCH["workloads"]}[workload]
    assert c.config["name"] == entry["config"]
    assert c.entry.__module__ == f"port_bench_entries_{c.traffic['entry']}"
    assert all(callable(getattr(c.entry, f)) for f in ("run", "values", "compare", "least_work"))
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert [m.name for m in c.per_layer] == [m["name"] for m in BENCH["per_layer"]]
    assert [n for n, _ in c.end_to_end] == ["train_rays_per_s", "setup_s"]
    assert all(callable(m.read) for m in c.per_layer)


def test_configs_state_source_and_cuts():
    for c in BENCH["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"] == []
        assert {"preset", "variant", "overrides", "assumed", "deployment", "config"} <= set(doc)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_port_preset_is_the_configuration(name):
    """The port's preset with the file's overrides equals the file's config."""
    from fruitnerf_tpu_torch.configs import apply_overrides, get_preset

    doc = json.loads((REPO / "port_bench" / "configs" / f"{name}.json").read_text())
    cfg = apply_overrides(get_preset(doc["preset"], 200, variant=doc["variant"]),
                          doc["overrides"])
    assert drive.config_diff(cfg, doc["config"]) == []


def test_new_metric_is_picked_up(tmp_path):
    """A metric file and its entry, added to a copy of the benchmark, reach
    every cell without an edit to any file that is there."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "extra.steps_traced", "unit": "1", "better": "higher",
                               "source": "device_trace", "layer": "step",
                               "moves": "train_rays_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "port_bench" / "metrics" / "extra.steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    for w in workloads():
        extra = [m for m in harness.cell(w, tmp_path).per_layer if m.name == "extra.steps_traced"]
        assert len(extra) == 1 and extra[0].read(type("C", (), {"steps": 7})()) == 7.0


EXTRA_ENTRY = """
from port_bench.harness import load_entry


class Entry(load_entry("train_loop")):
    unit_metric = "extra_rays_per_s"
"""


def test_new_entry_and_end_to_end_metric_are_picked_up(tmp_path):
    """A new kind of cell (an entry file, a traffic file naming it, its
    limits) with an end-to-end metric of its own runs through the harness,
    on the CPU at a shrunk size, with no file that is there edited."""
    from port_bench import run

    from . import tiny

    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fruit_nerf.grid.extra", "config": "fruit_nerf.grid",
                               "traffic": "extra", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "extra_rays_per_s", "unit": "rays/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "port_bench"
    (pb / "entries" / "extra.py").write_text(EXTRA_ENTRY)
    traffic = json.loads((pb / "traffic" / "train.json").read_text())
    (pb / "traffic" / "extra.json").write_text(json.dumps({**traffic, "entry": "extra"}))
    shutil.copy(pb / "limits" / "fruit_nerf.grid.train.json",
                pb / "limits" / "fruit_nerf.grid.extra.json")
    out = run.main(["--workload", "fruit_nerf.grid.extra", "--seed", "4000000011",
                    "--seconds", "0.3", "--trace", "0"], device="cpu", root=root,
                   cfg_check=False)
    assert out["correct"]
    assert set(out["metrics"]) == {"extra_rays_per_s", "setup_s"}
    assert out["metrics"]["extra_rays_per_s"]["value"] > 0


def _brute_touched(lay, pos):
    rows = set()
    for p in pos.tolist():
        for lvl, res in enumerate(lay.resolutions):
            s = [x * res for x in p]
            c = [int(torch.floor(torch.tensor(v, dtype=torch.float32))) for v in s]
            corners = [(c[0] + a, c[1] + b, c[2] + d) for a in (0, 1) for b in (0, 1)
                       for d in (0, 1)] if lay.corner else [tuple(c)]
            for x, y, z in corners:
                t = lay.rows[lvl]
                stride = res + 1 if lay.corner else res
                if lay.direct[lvl]:
                    idx = x + y * stride + z * stride * stride
                else:
                    idx = (x ^ ((y * LY.P1) & LY.MASK32) ^ ((z * LY.P2) & LY.MASK32)) & (t - 1)
                if 0 <= idx < t:
                    rows.add(lay.offsets[lvl] + idx)
    return len(rows)


@pytest.mark.parametrize("corner", [False, True])
def test_touched_rows_equal_a_loop(corner):
    g = torch.Generator().manual_seed(0)
    pos = torch.rand((300, 3), generator=g) * 0.999
    lay = (LY.corner_layout((4, 9, 30), 256, 2) if corner
           else LY.cell_layout((4, 9, 30), (128, 512, 256)))
    assert counts.touched_rows(lay, pos) == _brute_touched(lay, pos)


def test_grid_call_hand_count():
    """A 2-level cell layout of 128 rows each, 10 points, 5 rows touched."""
    lay = LY.cell_layout((2, 4), (128, 128))
    assert lay.rows == (128, 128) and lay.direct == (True, True)
    p, t = 10, 5
    fwd = 12 * p + 4 * 2 * 2 * p + 64 * t  # positions, features out, rows read
    assert counts.grid_call(lay, p, t, False, False) == fwd / counts.HBM_BYTES_PER_S
    bwd = 12 * p + 4 * 2 * 2 * p + 64 * 256 + 64 * t + 12 * p  # + dTable, rows, dPos
    assert counts.grid_call(lay, p, t, True, True) == bwd / counts.HBM_BYTES_PER_S


def test_mlp_hand_count():
    """One bf16 layer 4 -> 8 over 1000 rows: forward and backward."""
    d = (4, 1, 8, 8, False)
    fwd = max(2 * (1000 * 4 + 1000 * 8 + 32) / counts.HBM_BYTES_PER_S,
              2 * 1000 * 4 * 8 / counts.PEAK_BF16_FLOPS)
    assert counts.mlp_pass(1000, d, "bfloat16", False, False) == fwd
    dw = max((2 * (1000 * 4 + 1000 * 8) + 2 * 32 + 4 * 32) / counts.HBM_BYTES_PER_S,
             2 * 1000 * 4 * 8 / counts.PEAK_BF16_FLOPS)
    assert counts.mlp_pass(1000, d, "bfloat16", True, False) == dw
    assert counts.mlp_pass(1000, d, "bfloat16", True, True) == dw + fwd


def test_optimizer_and_step_count():
    """The fruit_nerf grid step at 200 images: every parameter counted once
    by the optimizer; the step's pieces add up to its total."""
    doc = json.loads((REPO / "port_bench" / "configs" / "fruit_nerf.grid.json").read_text())
    cfg = doc["config"]
    n = counts.num_params(cfg, 200)
    table = (12 * 4096 + 4 * 8192) * 16
    assert n > table and n - table < 100_000
    touched = {"field": 1000, "sparsity": 100}
    w = counts.step_least(cfg, 200, touched, 10000)
    assert w["optimizer"] == n * counts.ADAM_BYTES / counts.HBM_BYTES_PER_S
    assert w["total"] == pytest.approx(w["grid_fwd"] + w["grid_bwd"] + w["mlp"] + w["optimizer"])
    assert counts.step_least(cfg, 200, touched, 10001)["mlp"] < w["mlp"]  # proposals frozen


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_sources():
    for path in (REPO / "port_bench").rglob("*.py"):
        assert not (_imports(path) & set(FORBIDDEN)), path


def test_reference_sources_import_nothing_of_the_port():
    for path in (REPO / "port_bench" / "reference").rglob("*.py"):
        assert "fruitnerf_tpu_torch" not in _imports(path), path


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_loaded_modules():
    """Importing the harness, its traffic and metric files and the
    reference loads no JAX (top-level names compared whole); the reference
    alone loads nothing of the port."""
    everything = _loaded(
        "import port_bench.run, port_bench.harness, port_bench.drive, port_bench.check, "
        "port_bench.control, port_bench.counts, port_bench.trace, port_bench.training\n"
        "from port_bench import harness\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[harness.load_reader(m['name']) for m in b['per_layer']]\n"
        "[harness.cell(w['name']) for w in b['workloads']]\n")
    assert not everything & set(FORBIDDEN)
    ref = _loaded("import port_bench.reference.model, port_bench.reference.optim")
    assert "fruitnerf_tpu_torch" not in ref and not ref & set(FORBIDDEN)


class _Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, kind, name, start, end, corr=0, linked=0, thread=1):
        self._v = dict(device_type=kind, name=name, start_ns=start, duration_ns=end - start,
                       correlation_id=corr, linked_correlation_id=linked, start_thread_id=thread)

    def __getattr__(self, k):
        if k == "_v" or k not in self._v:
            raise AttributeError(k)
        return lambda: self._v[k]


def test_trace_ties_kernels_to_their_ops():
    """Host ops nest by time on their thread; a kernel carries the chain of
    the op that launched it; busy time is the union of device intervals."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from port_bench import trace as TR

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    raw = [
        _Ev(cpu, "autograd::engine::evaluate_function: _CellEncodeCUDABackward", 0, 100, corr=1),
        _Ev(cpu, "_CellEncodeBwdCUDA", 10, 90, corr=2),
        _Ev(cpu, "aten::mm", 200, 300, corr=3),
        _Ev(cpu, "cudaLaunchKernel", 20, 25, corr=9, linked=2),  # runtime call: not an op
        _Ev(cuda, "cell_encode_bwd_kernel", 1000, 3000, corr=9, linked=2),
        _Ev(cuda, "Memset (Device)", 900, 1000, corr=10, linked=2),
        _Ev(cuda, "gemm", 2500, 4000, corr=11, linked=3),
        _Ev(cuda, "Optimizer.step#Adam.step", 0, 9000, corr=12),
        _Ev(cpu, "Buffer Flush", 5, 6, corr=0),  # ops without an id of their own
        _Ev(cpu, "python op", 210, 220, corr=0),
        _Ev(cuda, "Memcpy DtoH", 5000, 5100, corr=13, linked=0),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    tr = TR.from_profile(prof, 2, 1e-5)
    assert [e.name for e in tr.events] == ["Memset (Device)", "cell_encode_bwd_kernel", "gemm",
                                           "Memcpy DtoH"]
    assert tr.events[1].ops == ("_CellEncodeBwdCUDA",
                                "autograd::engine::evaluate_function: _CellEncodeCUDABackward")
    assert tr.events[2].ops == ("aten::mm",)
    assert tr.events[3].ops == ()
    assert [TR.grid_part(e) for e in tr.events] == ["bwd", "bwd", None, None]
    assert tr.busy_s() == pytest.approx(3.2e-6)
    assert tr.device_us(lambda e: True) == pytest.approx(3.7)


@pytest.mark.parametrize("ops,name,part", [
    (("_CellEncodeCUDA", "aten::contiguous"), "k", "fwd"),
    (("_CornerEncodeCUDAGenerated",), "k", "fwd"),
    (("_CellEncodeBwdCUDA", "_CellEncodeCUDABackward"), "Memset (Device)", "bwd"),
    (("_CornerEncodeBwdCUDAGenerated",), "Memset (Device)", "bwd"),
    (("autograd::engine::evaluate_function: _CellEncodeCUDAGeneratedBackward",), "m", "bwd"),
    (("aten::mm",), "gemm", None),
    ((), "void corner_encode_bwd_kernel<2>(float const*)", "bwd"),
])
def test_grid_part(ops, name, part):
    """Grid work is told by the port's Functions (plain, under vmap, or
    their backward nodes), else by the kernel's name."""
    from port_bench.trace import DeviceEvent, grid_part

    assert grid_part(DeviceEvent(name, 0.0, 1.0, ops)) == part


def test_per_layer_readers_on_a_trace():
    """Every reader of the grid cell reads a small trace: the shares stay in
    (0, 100], the device times add up as the events say."""
    from types import SimpleNamespace

    from port_bench import run
    from port_bench.trace import DeviceEvent, Trace

    c = harness.cell("fruit_nerf.grid.train", REPO)
    cfg = harness.run_config(c)
    lay = LY.encoding_layout(cfg["model"]["field"]["grid"])
    g = torch.Generator().manual_seed(1)
    pos = {"field": torch.rand((4096 * 48, 3), generator=g),
           "sparsity": torch.rand((4096, 3), generator=g)}
    events = [  # two steps, in microseconds
        DeviceEvent("cell_encode_fwd_kernel", 0, 60, ("_CellEncodeCUDA",)),
        DeviceEvent("gemm", 100, 150, ("aten::mm", "aten::matmul")),
        DeviceEvent("cell_encode_bwd_kernel", 200, 500, ("_CellEncodeBwdCUDA",)),
        DeviceEvent("Memset (Device)", 500, 510, ("_CellEncodeBwdCUDA",)),
        DeviceEvent("multi_tensor_apply_kernel", 600, 700,
                    ("aten::_foreach_lerp_", "Optimizer.step#Adam.step")),
    ] * 2
    res = SimpleNamespace(trace=Trace(events, 2, 0.01), trace_first_step=10000,
                          info={"num_images": 200}, cpu_s=0.5, steps=20)
    ref = [{"positions": [(k, lay, p) for k, p in pos.items()]}]
    out = {k: v["value"] for k, v in run.per_layer(c, res, cfg, ref, 0.025).items()}
    assert out["loop.host_cpu_ms_per_step"] == pytest.approx(25.0)
    assert out["step.device_busy_ms"] == pytest.approx(0.52)
    assert out["model.mlp_device_ms"] == pytest.approx(0.05)
    assert out["optimizer.device_ms"] == pytest.approx(0.1)
    # the steps overlap: one union of 0.52 ms, over 2 steps of 25 ms untraced wall
    assert out["device.idle_share"] == pytest.approx(100 * (1 - 0.52e-3 / 2 / 0.025))
    for k in ("step.mfu", "grid_fwd.roofline", "grid_bwd.roofline"):
        assert 0 < out[k] <= 100, (k, out[k])
