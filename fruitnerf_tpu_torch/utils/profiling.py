"""Profiling hooks: wall time a named section, and a device trace. Twin of
``fruitnerf_tpu/utils/profiling.py``: ``StepTimer.section`` waits for the
devices of the tensors it is given, as the twin waits with
``jax.block_until_ready``; ``device_trace`` is a ``torch.profiler`` trace
over the CPU and, where there is one, the card, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


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
