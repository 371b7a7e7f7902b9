"""The port's stage spans (``utils/profiling.py:span``) on the CPU, on the
smoke preset with the sparsity prior on: off, they record nothing and enter
no ``record_function``; under ``torch.profiler`` or ``recording()`` the
train step, the train loop and the multi-scene step record each stage once
a step, on the profiler's clock; tracing changes no number; the sync hook
counts into the innermost open span; the benchmark's four readers of the
spans give hand-computed values; no span name is read by an older reader's
rule."""
import dataclasses
import statistics
import threading
import time
import warnings
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fruitnerf_tpu_torch.bridge import tree_leaves
from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine.trainer import init_train_state, train_loop, train_step
from fruitnerf_tpu_torch.parallel.multi_scene import (
    init_multi_scene_state, multi_scene_step, stack_datasets,
)
from fruitnerf_tpu_torch.utils import profiling
from fruitnerf_tpu_torch.utils.profiling import Span, recording, span, spans
from fruitnerf_tpu_torch.utils.writer import MetricWriter
from port_bench import harness
from port_bench.metrics_context import Context
from port_bench.trace import DeviceEvent, grid_part

FORWARD = ("rays", "sampler.spaced", "proposal.0", "sampler.pdf.0", "proposal.1",
           "sampler.pdf.1", "field", "render", "sparsity", "losses")
STEP = ("draws", *FORWARD, "backward", "optimizer", "metrics")
READERS = ("model.forward_host_ms", "step.backward_host_ms", "optimizer.host_ms",
           "step.host_syncs_per_step")


@pytest.fixture(scope="module")
def data():
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, fruit_radius=0.13, num_cameras=6,
                                              image_size=24, num_leaves=4), device="cpu")
    return dataset_from_scene(scene, "cpu")


@pytest.fixture(scope="module")
def config(data):
    cfg = fruit_nerf_smoke(data.cameras.num_cameras)
    model = dataclasses.replace(cfg.model, density_sparsity_mult=0.005, sparsity_num_points=64)
    return dataclasses.replace(cfg, model=model, train_rays_per_batch=64)


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _state(config, data, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_train_state(config, data.cameras.num_cameras, "cpu", generator=gen), gen


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the first range's set-up
            pass
        t0 = time.time_ns()
        fn()
        wall = (t0, time.time_ns())
    return prof, wall


def _top(recorded):
    return [s for s in recorded if s.parent is None]


def test_off_records_nothing_and_enters_no_range(config, data, monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    state, gen = _state(config, data)
    train_step(state, data, config, gen)
    assert spans() == [] and entered == [] and profiling.dropped_spans() == 0
    assert span("x") is span("y")  # the shared null context


def _contains_profiler_events(prof, recorded):
    """Each stored span holds the profiler's range of the same name: one
    clock. The ends lie a range's entry and exit apart (tens of µs): within
    1 ms at the median and 20 ms at most, room for a host thread that the
    OS sets aside between two reads of the clock on a loaded machine."""
    events: dict = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    seen: Counter = Counter()
    gaps = []
    for s in sorted(recorded, key=lambda s: s.start_ns):
        a, b = sorted(events[s.name])[seen[s.name]]
        seen[s.name] += 1
        assert s.start_ns <= a < b <= s.end_ns, s
        gaps += [a - s.start_ns, s.end_ns - b]
    assert statistics.median(gaps) < 1_000_000 and max(gaps) < 20_000_000, gaps


def test_train_step_stages_under_the_profiler(config, data):
    state, gen = _state(config, data)
    train_step(state, data, config, gen)  # first-call costs out of the way
    prof, (t0, t1) = _profiled(lambda: train_step(state, data, config, gen))
    recorded = spans()
    assert [s.name for s in recorded] == list(STEP)
    assert _top(recorded) == recorded
    assert {s.thread for s in recorded} == {threading.get_native_id()}
    assert sum(s.end_ns - s.start_ns for s in recorded) >= 0.9 * (t1 - t0)
    assert all(s.syncs == 0 for s in recorded)  # no card, no sync
    _contains_profiler_events(prof, recorded)


def test_train_loop_stages_every_step(config, data, tmp_path):
    cfg = dataclasses.replace(config, steps_per_log=1, steps_per_eval=2, steps_per_save=2,
                              max_iters=2, eval_rays_per_chunk=576)
    writer = MetricWriter(tmp_path / "metrics.jsonl", also_print=False)
    state, gen = _state(cfg, data)
    prof, _ = _profiled(lambda: train_loop(cfg, data, eval_indices=[0], state=state,
                                           generator=gen, writer=writer,
                                           checkpoint_dir=tmp_path / "ckpt"))
    recorded = spans()
    top = Counter(s.name for s in _top(recorded))
    assert top == {**{n: 2 for n in (*STEP, "log")}, "eval": 1, "save": 1}
    # the eval camera's forward runs inside "eval"
    assert {s.parent for s in recorded if s.parent} == {"eval"}
    _contains_profiler_events(prof, recorded)


def test_multi_scene_forward_nests_under_loss_and_grad(config, data):
    datas = stack_datasets([data, data])
    state, gens = init_multi_scene_state(config, data.cameras.num_cameras, 2, "cpu")
    with recording():
        multi_scene_step(state, datas, config, gens)
    recorded = spans()
    assert [s.name for s in _top(recorded)] == ["draws", "loss_and_grad", "optimizer", "metrics"]
    assert [s.name for s in recorded if s.parent == "loss_and_grad"] == list(FORWARD)
    assert min(profiling.self_ns(recorded)) >= 0


def test_tracing_changes_no_number(config, data):
    """Three steps with tracing off, under recording() and under the
    profiler: bitwise-equal losses and parameters (one thread)."""
    def three():
        state, gen = _state(config, data, seed=3)
        losses = torch.stack([train_step(state, data, config, gen)["total_loss"]
                              for _ in range(3)])
        return losses, [t.detach().clone() for t in tree_leaves(state.params)]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = three()
        with recording():
            recorded = three()
        with profile(activities=[ProfilerActivity.CPU]):
            profiled = three()
    finally:
        torch.set_num_threads(n)
    for losses, params in (recorded, profiled):
        assert torch.equal(losses, off[0])
        assert all(torch.equal(a, b) for a, b in zip(params, off[1]))


def test_sync_hook_counts_into_the_innermost_span(monkeypatch):
    """Torch's flagged syncs (its warning, driven here without a card) count
    into the innermost open span, every one; other warnings pass on; the
    sync debug mode is "warn" while a span is open where CUDA is
    initialised, and restored after the last one closes."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    flagged = profiling.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp:162.)"
    shown = warnings.showwarning
    with recording(), pytest.warns(DeprecationWarning, match="passes on"):
        with span("outer"):
            assert modes == ["default", "warn"]
            with span("inner"):
                for _ in range(2):  # one line, twice: every one counts
                    warnings.warn(flagged, UserWarning)
            profiling._on_warning(UserWarning(flagged), UserWarning, "x.py", 1)
            warnings.warn("passes on", DeprecationWarning)
        assert modes == ["default", "warn", "default"]
    assert warnings.showwarning is shown
    assert {s.name: s.syncs for s in spans()} == {"inner": 2, "outer": 1}
    with recording():  # no span open on this thread: not counted, not shown
        profiling._on_warning(UserWarning(flagged), UserWarning, "x.py", 1)
    assert len(spans()) == 2


def test_spans_past_the_cap_are_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with recording():
        for name in "abc":
            with span(name):
                pass
    assert [s.name for s in spans()] == ["a", "b"] and profiling.dropped_spans() == 1


def _ms(a, b, name, parent=None, syncs=0, thread=7):
    return Span(name, parent, thread, int(a * 1e6), int(b * 1e6), syncs)


HAND = [  # two steps (ms); a grid step, then a campaign step
    _ms(0, 1, "draws"), _ms(1, 2, "rays"), _ms(2, 3, "sampler.spaced"),
    _ms(3, 5, "proposal.0"), _ms(5, 6, "sampler.pdf.0"), _ms(6, 9, "field"),
    _ms(9, 10, "render"), _ms(10, 11, "losses"), _ms(11, 20, "backward", syncs=2),
    _ms(20, 23, "optimizer"), _ms(23, 24, "metrics"),
    _ms(51, 53, "rays", "loss_and_grad"), _ms(55, 60, "field", "loss_and_grad"),
    _ms(50, 80, "loss_and_grad"), _ms(80, 82, "optimizer"), _ms(90, 91, "log", syncs=1),
    _ms(0, 40, "optimizer", thread=8),  # another thread: not inside anything of thread 7
]


def test_readers_on_a_hand_made_span_list(monkeypatch):
    """Self times: forward 10 ms + 7 ms (loss_and_grad's rays and field),
    backward 9 ms + loss_and_grad's 30 - 7 = 23 ms, optimizer 3 + 2 + 40
    ms; over a traced window of 0.1 s scaled to 25 ms a step untraced
    (x 0.25 a second of span); syncs 3 over 2 steps."""
    ctx = Context(trace=SimpleNamespace(window_s=0.1), work={}, steps=2,
                  host_cpu_s_per_step=0.02, wall_s_per_step=0.025)
    read = {n: harness.load_reader(n) for n in READERS}
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert all(r(ctx) is None for r in read.values())
    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    assert profiling.self_ns(HAND)[HAND.index(_ms(50, 80, "loss_and_grad"))] == 23_000_000
    got = {n: r(ctx) for n, r in read.items()}
    assert got == pytest.approx({"model.forward_host_ms": 17 * 0.25,
                                 "step.backward_host_ms": 32 * 0.25,
                                 "optimizer.host_ms": 45 * 0.25,
                                 "step.host_syncs_per_step": 1.5})


def test_no_span_name_is_read_by_an_older_rule():
    """The device readers' rules (grid_part, the optimizer's ops, the MLP
    matmuls) read nothing new when a span is the outermost op."""
    mine = harness._load(harness.HERE, "metrics", "optimizer.device_ms")._mine
    matmuls = harness._load(harness.HERE, "metrics", "model.mlp_device_ms").MATMULS
    names = (*STEP, "loss_and_grad", "log", "eval", "save", "field.trunk", "field.heads")
    for name in names:
        for ops in ((name,), ("aten::mul", name)):
            e = DeviceEvent("void elementwise_kernel", 0.0, 1.0, ops)
            assert grid_part(e) is None and not mine(e) and e.ops[0] not in matmuls
        assert not any(k in name for k in ("#", "Backward", "_CellEncode", "_CornerEncode",
                                           "Optimizer.step"))
