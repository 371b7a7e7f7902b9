"""Where a benchmark cell's train step spends the card's time, with the step
built as ``port_bench`` builds the cell: (1) each proposal gate's CUDA-graph
replay timed by CUDA events, and the loop's wall a step; (2) every device
event of profiled replays, ``#`` names kept (``port_bench/trace.py`` drops
them): busy time, span and the busiest kernels; (3) an eager profiled step
of each gate, every kernel attributed to the innermost stage span
(``utils/profiling.py``) of its launching op, a backward kernel to the span
of its forward op through the autograd sequence number; the lambda-templated
elementwise kernels summed by stage. A cell of the ``multi_scene`` entry
(the campaign) steps through ``multi_scene_step`` with its scene generators.

    python scripts_dev/step_probe.py --workload semantic_nerf.tpu.train \
        [--seed N] [--device cuda|cpu] [--json out.json]

On the CPU (``--device cpu``, with ``--root`` a shrunk benchmark) it runs
part (3) only, ATen ops standing in for kernels.
"""
import argparse
import collections
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from port_bench import drive, harness
from fruitnerf_tpu_torch.engine import step_graph
from fruitnerf_tpu_torch.engine.trainer import train_step
from fruitnerf_tpu_torch.models.fruit_model import proposal_updated
from fruitnerf_tpu_torch.ops import hash_grid as hg
from fruitnerf_tpu_torch.parallel.multi_scene import multi_scene_step

STAGES = ("draws", "rays", "sampler.spaced", "field", "field.trunk", "field.heads", "render",
          "sparsity", "losses", "backward", "optimizer", "metrics", "graph", "graph.capture", "log")


def is_stage(name):
    return name in STAGES or name.startswith(("proposal.", "sampler.pdf."))


def device_events(prof, dev):
    """[(name, start_ns, end_ns, corr)] of the device, user ranges left out,
    '#' names kept unless they mirror a record_function range."""
    out = []
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if dev.type != "cuda":  # a CPU rehearsal: ATen ops stand in for kernels
            if e.device_type() == DeviceType.CPU and n.startswith("aten::"):
                out.append((n, e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
            continue
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation() or n.startswith("ProfilerStep") or "Optimizer.step#" in n \
                or is_stage(n):
            continue
        out.append((n, e.start_ns(), e.start_ns() + e.duration_ns(), e.linked_correlation_id()))
    return out


def union_ns(evs):
    tot, cur = 0, None
    for _, a, b, _ in sorted(evs, key=lambda x: x[1]):
        if cur is None or a > cur[1]:
            if cur:
                tot += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return tot + (cur[1] - cur[0] if cur else 0)


def attribute(prof, dev):
    """{stage: [device us, events]} and {(stage, kernel): us} over the
    profile: a kernel's stage is the innermost stage span around its
    launching op; a backward op's is that of its forward op."""
    raw = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CPU]
    ops = sorted([(e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
                   e.correlation_id(), e.name(), e.sequence_nr(), e.fwd_thread_id())
                  for e in raw if not e.name().startswith("[memory]")],
                 key=lambda o: (o[0], -o[1]))
    parent = [-1] * len(ops)
    stacks, of_corr, fwd_of_seq = {}, {}, {}
    for i, (a, b, th, corr, name, seq, fth) in enumerate(ops):
        st = stacks.setdefault(th, [])
        while st and ops[st[-1]][1] <= a:
            st.pop()
        parent[i] = st[-1] if st else -1
        of_corr[corr] = i
        if seq >= 0 and not fth and (th, seq) not in fwd_of_seq:
            fwd_of_seq[(th, seq)] = i  # the outermost forward op of that sequence number
        st.append(i)

    def stage(i, hops=0):
        j = i
        while j >= 0:
            name, seq, fth = ops[j][4], ops[j][5], ops[j][6]
            if is_stage(name) and name != "backward":
                return name
            if fth and seq >= 0 and hops == 0 and (fth, seq) in fwd_of_seq:
                return "bwd<-" + stage(fwd_of_seq[(fth, seq)], 1)
            if name == "backward":
                return "backward"
            j = parent[j]
        return "(none)"

    by_stage = collections.defaultdict(lambda: [0.0, 0])
    by_kernel = collections.defaultdict(float)
    for n, a, b, corr in device_events(prof, dev):
        s = stage(of_corr.get(corr, -1))
        by_stage[s][0] += (b - a) / 1e3
        by_stage[s][1] += 1
        by_kernel[(s, n)] += (b - a) / 1e3
    return by_stage, by_kernel


def short(n, k=110):
    return n if len(n) <= k else n[:k] + "..."


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=2718281829)
    p.add_argument("--device", default="cuda")
    p.add_argument("--workload", required=True)
    p.add_argument("--warm", type=int, default=12)
    p.add_argument("--replays", type=int, default=20)
    p.add_argument("--profiled", type=int, default=5)
    p.add_argument("--root", default=None)
    p.add_argument("--json", default=None)
    a = p.parse_args()
    dev = torch.device(a.device)
    out = {"seed": a.seed}
    if dev.type == "cuda":
        hg.build_kernels()
    cell = harness.cell(a.workload, a.root)
    entry = cell.entry(cell, drive.seeds(a.seed), dev, a.root is None)
    st, cfg = entry.state, entry.config
    if hasattr(entry, "datas"):  # the multi-scene entry

        def step():
            return multi_scene_step(st, entry.datas, cfg, entry.generators)
    else:

        def step():
            return train_step(st, entry.data, cfg, entry.generator)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(a.warm):
        step()
    sync()
    # (1) a replay of each gate by CUDA events; the loop's wall a step
    if dev.type == "cuda":
        graphs = st.graphs.graphs
        out["keys"] = [list(k) for k in sorted(graphs)]
        out["replay_ms"] = {}
        for key in sorted(graphs):
            g = graphs[key]
            ts = []
            for _ in range(a.replays):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record(); g.replay(); e.record()
                ts.append((s, e))
            sync()
            ms = [s.elapsed_time(e) for s, e in ts]
            out["replay_ms"][str(key)] = {"median": statistics.median(ms), "min": min(ms),
                                          "max": max(ms)}
        n = 50
        t = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        out["loop_wall_ms"] = (time.perf_counter() - t) / n * 1e3
        # (2) profiled replays of each gate
        out["replays"] = {}
        for key in sorted(graphs):
            g = graphs[key]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(a.profiled):
                    g.replay()
                sync()
            evs = device_events(prof, dev)
            by = collections.Counter()
            for nme, s0, e0, _ in evs:
                by[nme] += (e0 - s0) / 1e3 / a.profiled
            busy = union_ns(evs) / 1e6 / a.profiled
            span = (max(e[2] for e in evs) - min(e[1] for e in evs)) / 1e6 / a.profiled
            out["replays"][str(key)] = {
                "events_per_replay": len(evs) / a.profiled, "busy_ms": busy, "span_ms": span,
                "sum_ms": sum(by.values()) / 1e3,
                "top": [[short(k), v / 1e3] for k, v in by.most_common(25)]}
    # (3) eager traced steps: one of each gate, every kernel to its stage
    real = step_graph.replay_key
    step_graph.replay_key = lambda *x, **k: None
    try:
        while proposal_updated(st.step, cfg.model):
            step()
        sync()
        res = {}
        for gate in (False, True):
            while proposal_updated(st.step, cfg.model) != gate:
                step()
            sync()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                step()
                sync()
            by_stage, by_kernel = attribute(prof, dev)
            lam = collections.defaultdict(float)
            for (s, nme), us in by_kernel.items():
                if "lambda" in nme:
                    lam[s] += us
            res["gate_" + ("on" if gate else "off")] = {
                "stages_ms": {k: [v[0] / 1e3, v[1]] for k, v in
                              sorted(by_stage.items(), key=lambda kv: -kv[1][0])},
                "lambda_ms_by_stage": {k: v / 1e3 for k, v in
                                       sorted(lam.items(), key=lambda kv: -kv[1])},
                "lambda_ms": sum(lam.values()) / 1e3,
                "top": [[s, short(nme), us / 1e3] for (s, nme), us in
                        sorted(by_kernel.items(), key=lambda kv: -kv[1])[:30]]}
        out["eager"] = res
    finally:
        step_graph.replay_key = real
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    txt = json.dumps(out, indent=1)
    print(txt)
    if a.json:
        os.makedirs(os.path.dirname(a.json), exist_ok=True)
        open(a.json, "w").write(txt)
    entry.close()


if __name__ == "__main__":
    main()
