"""The traced window: ``torch.profiler`` over CPU and CUDA activity, reduced
to device intervals, each with the chain of host ops that launched it.

A device event (kernel, memset or copy; not a user annotation's range) is
tied to the host op that launched it by the profiler's correlation id, and
from there up the ops that enclose it on its thread: ``ops`` is that
chain, innermost first.
"""
from __future__ import annotations

import dataclasses

from torch.autograd import DeviceType


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start_us: float
    end_us: float
    ops: tuple[str, ...]  # launching host op, then its parents

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    events: list  # [DeviceEvent], by start
    steps: int  # train steps in the traced window
    window_s: float  # the traced window's wall seconds

    def device_us(self, pred) -> float:
        """Device microseconds of the events for which ``pred(event)``."""
        return sum(e.us for e in self.events if pred(e))

    def busy_intervals(self) -> list[tuple[float, float, DeviceEvent]]:
        """The union of the device intervals, each with the event that
        opens it."""
        out = []
        for e in self.events:
            if out and e.start_us <= out[-1][1]:
                if e.end_us > out[-1][1]:
                    out[-1] = (out[-1][0], e.end_us, out[-1][2])
            else:
                out.append((e.start_us, e.end_us, e))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b, _ in self.busy_intervals()) / 1e6


def _call(e, name, default=None):
    f = getattr(e, name, None)
    return default if f is None else f()


def from_profile(prof, steps: int, window_s: float) -> Trace:
    """The profiler's raw events (``kineto_results``, which cost far less to
    read than ``prof.events()``): host ops nested by time on each thread,
    device events tied to the op whose correlation id they carry."""
    raw = prof.profiler.kineto_results.events()
    ops = []  # host ops: (start, end, thread, correlation id, name)
    dev = []
    for e in raw:
        kind = e.device_type()
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind == DeviceType.CPU:
            if _call(e, "linked_correlation_id", 0) == 0 and not name.startswith("[memory]"):
                ops.append((start, end, _call(e, "start_thread_id", 0), e.correlation_id(), name))
        elif kind == DeviceType.CUDA:
            # record_function ranges mirrored on the device timeline overlap
            # the kernels they hold (the optimizer's "Optimizer.step#Adam.step")
            if _call(e, "is_user_annotation", False) or "#" in name \
                    or name.startswith("ProfilerStep"):
                continue
            dev.append((start, end, _call(e, "linked_correlation_id", 0), name))
    # an op's parent is the op on its thread that encloses it, found by a
    # stack over the ops in start order: an earlier op, so no chain loops
    ops.sort(key=lambda o: (o[0], -o[1]))
    parent = [-1] * len(ops)
    of_corr: dict = {}  # correlation id -> op index (ids are not all unique)
    stacks: dict = {}
    for i, (start, end, thread, corr, _) in enumerate(ops):
        stack = stacks.setdefault(thread, [])
        while stack and ops[stack[-1]][1] <= start:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        if corr:
            of_corr[corr] = i
        stack.append(i)
    chains: dict = {}

    def chain(corr):
        i = of_corr.get(corr, -1) if corr else -1
        if i not in chains:
            out, j = [], i
            while j >= 0:
                out.append(ops[j][4])
                j = parent[j]
            chains[i] = tuple(out)
        return chains[i]

    t0 = min((d[0] for d in dev), default=0)
    out = [DeviceEvent(name, (a - t0) / 1e3, (b - t0) / 1e3, chain(corr))
           for a, b, corr, name in dev]
    out.sort(key=lambda d: d.start_us)
    return Trace(out, steps, window_s)


def _label(e: DeviceEvent) -> str:
    if not e.ops:
        return e.name[:80]
    if len(e.ops) == 1:
        return e.ops[0]
    return f"{e.ops[-1]} > {e.ops[0]}"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took the most time, and the idle gaps summed by
    the host op whose launch ends them (outermost > innermost), seconds."""
    by_name: dict = {}
    for e in trace.events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.us / 1e6
    gaps: dict = {}
    prev_end = None
    for a, b, first in trace.busy_intervals():
        if prev_end is not None and a > prev_end:
            key = _label(first)
            gaps[key] = gaps.get(key, 0.0) + (a - prev_end) / 1e6
        prev_end = b
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k[:200], v] for k, v in idle]}


# the port's grid-encoding autograd Functions, as the profiler names their
# host ops: the class name, with "Generated" added under torch.func.vmap,
# and "Backward" on the autograd node of a backward
GRID_FWD_OPS = ("_CellEncodeCUDA", "_CornerEncodeCUDA")
GRID_BWD_OPS = ("_CellEncodeBwdCUDA", "_CornerEncodeBwdCUDA")
GRID_FWD_KERNELS = ("cell_encode_fwd", "corner_encode_fwd")
GRID_BWD_KERNELS = ("cell_encode_bwd", "corner_encode_bwd", "column_max_kernel",
                    "fixed_to_float_kernel")


def grid_part(e: DeviceEvent) -> str | None:
    """"bwd", "fwd" or None: whether the event belongs to a grid encoding's
    backward or forward, by its launching ops, else by its kernel name."""
    if any(k in o for o in e.ops for k in GRID_BWD_OPS) or any(
            k in o and "Backward" in o for o in e.ops for k in GRID_FWD_OPS):
        return "bwd"
    if any(k in o for o in e.ops for k in GRID_FWD_OPS):
        return "fwd"
    if any(k in e.name for k in GRID_BWD_KERNELS):
        return "bwd"
    if any(k in e.name for k in GRID_FWD_KERNELS):
        return "fwd"
    return None
