"""Profiling hooks: wall time a named section, a device trace, and the
port's stage spans.

``StepTimer`` and ``device_trace`` are twins of
``fruitnerf_tpu/utils/profiling.py``: ``StepTimer.section`` waits for the
devices of the tensors it is given, as the twin waits with
``jax.block_until_ready``; ``device_trace`` is a ``torch.profiler`` trace
over the CPU and, where there is one, the card, written as a Chrome trace.

``span(name)`` marks a stage of the train step. Tracing is off unless a
``torch.profiler`` records or a ``recording()`` block is open; then a span
costs one flag check and one ``_profiler_enabled()`` call and does nothing.
With tracing on, a span

* enters ``torch.profiler.record_function(name)`` while a profiler
  records, so the stage is in the profiler's trace and every kernel
  launched inside it on its thread carries the name in its op chain;
* on leaving, appends a ``Span`` to an in-memory list (``spans()``, at
  most ``MAX_SPANS``; ``dropped_spans()`` counts the rest), timed with
  ``time.time_ns()``, the clock of the profiler's host events, just
  outside the profiler's range, so that it contains the range;
* counts the host's synchronisations with the card that torch flags
  (``torch.cuda.set_sync_debug_mode("warn")`` while any span is open:
  device-to-host copies, ``.item()``, ``.tolist()``, ``nonzero``, a
  stream's ``synchronize()``; torch does not flag
  ``torch.cuda.synchronize()``) into the innermost open span of the thread
  that waited, and keeps their warnings quiet.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled


def _devices(tree) -> set:
    """The devices of the tensors in a tensor or a nested dict/list/tuple."""
    if isinstance(tree, torch.Tensor):
        return {tree.device}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_devices, tree))
    return set()


def block_until_ready(tree):
    """Wait until every card that holds a tensor of ``tree`` has finished
    its queued work; CPU tensors are ready when they exist."""
    for dev in _devices(tree):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


class StepTimer:
    """Accumulates wall time per named section; report() gives ms averages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (a tensor or a nested dict/list
        of them), wait for their devices before the clock stops."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: 1e3 * self.totals[name] / max(self.counts[name], 1)
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir):
    """``torch.profiler`` over the block, CPU activity and, where torch
    finds a card, CUDA activity; the Chrome trace goes to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto). Yields
    the profiler, whose ``key_averages()`` sums the ops."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


# ---------------------------------------------------------------------------
# stage spans
# ---------------------------------------------------------------------------

MAX_SPANS = 1_000_000
# the start of the warning torch gives for a flagged synchronisation
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    """A closed span. ``parent``: the name of the span open around it on its
    thread (None at the top level); ``thread``: the OS thread id; times in
    ``time.time_ns()`` nanoseconds; ``syncs``: the flagged synchronisations
    made inside it and outside its child spans."""

    name: str
    parent: str | None
    thread: int
    start_ns: int
    end_ns: int
    syncs: int


_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_spans: list[Span] = []
_dropped = 0
_recording = 0  # depth of open recording() blocks
_local = threading.local()  # .stack: this thread's open spans, innermost last
_hook_users = 0  # open spans on every thread, while the sync hook is in place
_hook = None  # (its catch_warnings, the previous showwarning, the previous sync mode)


def span(name: str):
    """A context that records the stage ``name`` while tracing is on (see
    the module docstring), else a shared null context."""
    if _recording or _profiler_enabled():
        return _OpenSpan(name)
    return _NULL


@contextlib.contextmanager
def recording():
    """Tracing on over the block without a profiler: spans are recorded and
    syncs counted; no ``record_function`` range is entered."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> list[Span]:
    """The spans recorded since the last ``clear_spans()``, in the order
    they closed."""
    with _lock:
        return list(_spans)


def dropped_spans() -> int:
    """Spans closed while the list held ``MAX_SPANS``, not recorded."""
    return _dropped


def clear_spans():
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def self_ns(recorded: list[Span]) -> list[int]:
    """Each span's self time in ns: its duration less the part of it that
    its child spans (those open directly inside it on its thread) cover."""
    out = [s.end_ns - s.start_ns for s in recorded]
    order = sorted(range(len(recorded)),
                   key=lambda i: (recorded[i].thread, recorded[i].start_ns, -recorded[i].end_ns))
    stack: list[int] = []  # the spans open around the current one
    thread = None
    for i in order:
        s = recorded[i]
        if s.thread != thread:
            stack, thread = [], s.thread
        while stack and recorded[stack[-1]].end_ns <= s.start_ns:
            stack.pop()
        if stack:
            out[stack[-1]] -= s.end_ns - s.start_ns
        stack.append(i)
    return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _OpenSpan:
    __slots__ = ("name", "parent", "syncs", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if not stack:
            _hook_syncs()
        self.parent = stack[-1].name if stack else None
        self.syncs = 0
        self.range = None
        self.start = time.time_ns()
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _dropped
        stack = _stack()
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        closed = Span(self.name, self.parent, threading.get_native_id(), self.start,
                      time.time_ns(), self.syncs)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(closed)
            else:
                _dropped += 1
        if not stack:
            _unhook_syncs()
        return False


def _hook_syncs():
    """Put the sync hook in place for the first open span: every flagged
    sync warning shown, to ``_on_warning``; torch's sync debug mode at
    "warn" where CUDA is initialised (no CUDA work, no sync to flag)."""
    global _hook_users, _hook
    with _lock:
        _hook_users += 1
        if _hook_users > 1:
            return
        guard = warnings.catch_warnings()
        guard.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        previous = warnings.showwarning
        warnings.showwarning = _on_warning
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _hook = (guard, previous, mode)


def _unhook_syncs():
    """Take the sync hook away when the last open span closes."""
    global _hook_users, _hook
    with _lock:
        _hook_users -= 1
        if _hook_users:
            return
        guard, _, mode = _hook
        _hook = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        guard.__exit__(None, None, None)


def _on_warning(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while a span is open: a flagged sync counts
    into this thread's innermost open span; any other warning goes to the
    hook that was in place before."""
    if str(message).startswith(SYNC_WARNING):
        stack = _stack()
        if stack:
            stack[-1].syncs += 1
        return
    hook = _hook
    if hook is not None:
        hook[1](message, category, filename, lineno, file, line)
