"""The port's profiling hooks (``utils/profiling.py``) on the CPU:
``StepTimer`` sections and ``report()`` as the JAX twin's, with
``block_on`` taking a tensor or a nested dict/list of them, and
``device_trace`` writing a Chrome trace of the ops it saw."""
import json
import time

import jax.numpy as jnp
import pytest
import torch

from fruitnerf_tpu.utils.profiling import StepTimer as JaxStepTimer
from fruitnerf_tpu_torch.utils import profiling
from fruitnerf_tpu_torch.utils.profiling import StepTimer, block_until_ready, device_trace

SLEEP_S = 0.02


def _fill(timer, block_on):
    for _ in range(3):
        with timer.section("a", block_on=block_on):
            time.sleep(SLEEP_S)
    with timer.section("b"):
        pass
    return timer.report()


def test_step_timer_sections_and_report_as_the_twins():
    """Same sections, same counts; each mean at least the time slept (in
    ms), the empty one under it."""
    tree = {"x": torch.ones(3), "y": [torch.zeros(2), (torch.ones(1),)]}
    got = _fill(StepTimer(), tree)
    want = _fill(JaxStepTimer(), {"x": jnp.ones(3)})
    assert set(got) == set(want) == {"a", "b"}
    assert got["a"] >= 1e3 * SLEEP_S and got["b"] < 1e3 * SLEEP_S
    timer = StepTimer()
    _fill(timer, tree)
    assert dict(timer.counts) == {"a": 3, "b": 1}
    assert timer.report()["a"] == pytest.approx(1e3 * timer.totals["a"] / 3)


def test_block_on_waits_for_the_devices_of_the_tensors(monkeypatch):
    """Every card a tensor of the tree lies on is synchronised once; CPU
    tensors and other leaves need no wait."""
    synced = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", synced.append)
    fake = torch.empty(1, device="meta")  # stands in for a tensor on another device
    monkeypatch.setattr(profiling, "_devices", lambda tree: {torch.device("cuda", 0),
                                                              torch.device("cuda", 1),
                                                              fake.device})
    assert block_until_ready("tree") == "tree"
    assert sorted(d.index for d in synced) == [0, 1]
    monkeypatch.undo()
    tree = {"a": [torch.ones(1), (torch.zeros(1), 3)], "b": "text"}
    assert profiling._devices(tree) == {torch.device("cpu")}
    assert profiling._devices([]) == set()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace") as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(r.key == "aten::mm" for r in prof.key_averages())
