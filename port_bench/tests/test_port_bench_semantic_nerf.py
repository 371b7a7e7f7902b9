"""The ``semantic_nerf.tpu.train`` cell (the reference's SemanticNeRFField at
its published widths): the harness finds its entry, traffic, limits and
the ``mlp.roofline`` metric by name; its counted least work equals a hand
count of the trunk with its 319-wide skip layer; the metric reads GEMM
kernels by name and nothing in a cell whose entry counts no MLP stage; its
controls fail its limits at the shrunk size. A whole run with a frozen or
half-batch step is not correct on it (``test_port_bench_faults.py``, which
takes every cell)."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from port_bench import check, control_semantic_nerf, counts, harness, run
from port_bench import semantic_nerf as SNB
from port_bench.trace import DeviceEvent, Trace

from . import tiny

WORKLOAD = "semantic_nerf.tpu.train"
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_harness_finds_the_cell():
    c = harness.cell(WORKLOAD, tiny.REPO)
    assert c.chips == 1 and c.config["name"] == "semantic_nerf.tpu"
    assert c.traffic["entry"] == "semantic_nerf_loop"
    assert c.entry.__module__ == "port_bench_entries_semantic_nerf_loop"
    assert c.entry.compare is not harness.load_entry("train_loop").compare
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "mlp.roofline"]
    assert (m["layer"], m["moves"], m["workloads"]) == ("kernels", "train_rays_per_s", [WORKLOAD])
    assert "mlp.roofline" in [x.name for x in c.per_layer]
    # the traffic is the train traffic, naming this entry
    train = json.loads((tiny.REPO / "port_bench" / "traffic" / "train.json").read_text())
    assert {k: v for k, v in c.traffic.items() if k not in ("entry", "about")} == \
        {k: v for k, v in train.items() if k not in ("entry", "about")}


def _least(n, a, b, backward=False, dx=False):
    """One bf16 layer a -> b over n rows, by hand: the forward, or the weight
    gradient (reading its input and gradient, writing dW in bf16 and float32)
    and with ``dx`` the input gradient."""
    def piece(nbytes, flops):
        return max(nbytes / counts.HBM_BYTES_PER_S, flops / counts.PEAK_BF16_FLOPS)

    fwd = piece(2 * (n * a + n * b + a * b), 2.0 * n * a * b)
    if not backward:
        return fwd
    return piece(2 * (n * a + n * b) + 2 * a * b + 4 * a * b, 2.0 * n * a * b) + (fwd if dx else 0)


def test_least_work_equals_a_hand_count():
    """One gate-off step of the cell (8192 rays x 128 fine samples, camera-opt
    live): the trunk 63 -> 256, three 256 -> 256, the skip layer 319 -> 256,
    three 256 -> 256, each forward and weight gradient, every input gradient
    (the first layer's and the skip layer's whole 319 too: the samples move
    with the cameras); the heads 256 -> 1, 283 -> 128 -> 3 and 256 -> 64 -> 1
    (no input gradient into the detached semantic branch); the sparsity
    points' trunk without the encoding's input gradient (the skip layer's
    256 hidden columns alone)."""
    cfg = harness.run_config(harness.cell(WORKLOAD, tiny.REPO))
    n, sp = 8192 * 128, 4096
    trunk = [(63, 256)] + [(256, 256)] * 3 + [(319, 256)] + [(256, 256)] * 3
    field = sum(_least(n, a, b) + _least(n, a, b, True, True) for a, b in trunk)
    field += _least(n, 256, 1) + _least(n, 256, 1, True, True)
    field += sum(_least(n, a, b) + _least(n, a, b, True, True) for a, b in ((283, 128), (128, 3)))
    field += _least(n, 256, 64) + _least(n, 256, 64, True) + _least(n, 64, 1) \
        + _least(n, 64, 1, True, True)
    sparse = sum(_least(sp, a, b) + _least(sp, a, b, True) for a, b in trunk)
    sparse += sum(_least(sp, a, b) for a, b in trunk[1:4] + trunk[5:]) + _least(sp, 256, 256)
    sparse += _least(sp, 256, 1) + _least(sp, 256, 1, True, True)
    w = SNB.step_least(cfg, 200, 10001)
    assert w["mlp.field"] == pytest.approx(field, rel=1e-12)
    assert w["mlp.sparsity"] == pytest.approx(sparse, rel=1e-12)
    # the frozen proposals' forwards alone on a gate-off step, their backward on a gate-on one
    on = SNB.step_least(cfg, 200, 10000)
    assert on["mlp.proposals"] > w["mlp.proposals"] > 0
    assert on["mlp.field"] == w["mlp.field"]
    n_p = sum(a * b + b for a, b in trunk + [(256, 1), (283, 128), (128, 3), (256, 64), (64, 1)])
    n_p += sum(a * b + b for a, b in ((33, 32), (32, 1), (45, 64), (64, 64), (64, 1))) + 200 * 6
    assert w["optimizer"] == n_p * counts.ADAM_BYTES / counts.HBM_BYTES_PER_S
    assert w["mlp"] == pytest.approx(w["mlp.field"] + w["mlp.sparsity"] + w["mlp.proposals"])
    assert w["total"] == pytest.approx(w["mlp"] + w["optimizer"])


def test_mlp_roofline_reads_gemm_kernels_by_name():
    """The least time of the window's MLP products over the device time of
    the kernels named as GEMMs (an elementwise kernel left out), and no
    reading from a cell whose entry counts no MLP product by stage."""
    c = harness.cell(WORKLOAD, tiny.REPO)
    cfg = harness.run_config(c)
    events = [DeviceEvent("nvjet_tst_128x288_64x4_2x1_v_bz_coopA_NNT", 0, 30000, ()),
              DeviceEvent("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm>", 30000,
                          50000, ()),
              DeviceEvent("void gemv2T_kernel_val<int, int, __nv_bfloat16>", 50000, 51000, ()),
              DeviceEvent("void at::native::elementwise_kernel<128, 4>", 51000, 90000, ())] * 2
    res = SimpleNamespace(trace=Trace(events, 2, 0.2), trace_first_step=10001,
                          info={"num_images": 200}, cpu_s=0.2, steps=4)
    out = {k: v["value"] for k, v in run.per_layer(c, res, cfg, [], 0.1).items()}
    least = sum(SNB.step_least(cfg, 200, s)["mlp"] for s in (10001, 10002))
    assert out["mlp.roofline"] == pytest.approx(100 * least / (2 * 51000e-6))
    assert 0 < out["mlp.roofline"] <= 100 and 0 < out["step.mfu"] <= 100
    reader = harness.load_reader("mlp.roofline")
    ctx = SimpleNamespace(trace=res.trace, work={"mlp": 1.0, "total": 1.0})
    assert reader(ctx) is None  # the FruitField entries' work has no "mlp.<stage>" pieces


def test_controls_fail_the_limits(root):
    cell = harness.cell(WORKLOAD, root)
    limits = json.loads((tiny.REPO / "port_bench" / "limits" / f"{WORKLOAD}.json").read_text())
    r = control_semantic_nerf.readings(cell, 22, list(control_semantic_nerf.FAULTS),
                                       torch.device("cpu"))
    for fault in ("lower", "keep_half"):
        assert not check.verdict(r[fault], limits), (fault, r[fault])
    assert r["frozen"]["change_gap"] == pytest.approx(1.0)
