"""The plain reference equals the port on the CPU for one step at a shrunk
preset of each configuration; the control and the planted faults read
above the limits that decide ``correct``."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import check, control, drive, harness, scene as SC, weights
from port_bench.reference import model as RM
from port_bench.reference.optim import Optimizer, leaves

from . import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["fruit_nerf.grid.train", "fruit_nerf_huge.parity.train"])
def test_reference_equals_port_one_step(root, workload):
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.engine.trainer import draw_step, init_train_state, train_step

    torch.manual_seed(0)
    cell = harness.cell(workload, root)
    cfg = harness.run_config(cell)
    dev = torch.device("cpu")
    (sp,) = drive.scene_params(cell.traffic, 5)
    sc = SC.render(sp, dev)
    n = sp["num_cameras"]
    config = drive.program_config(cell, n, strict=False)
    data = dataset_from_scene(sc, dev, train_fraction=drive.split_of(cfg, cell.traffic))
    step = cell.traffic["start_step"]

    state = init_train_state(config, n, dev, params=weights.make(cfg, n, 11, dev))
    state.step = step
    draws = draw_step(config, data, torch.Generator().manual_seed(13))
    metrics = train_step(state, data, config, draws=draws)

    params = weights.make(cfg, n, 11, dev)
    rdata = check.ref_data(sc, cfg, cell.traffic, dev)
    rdraws = RM.draw_step(cfg, len(rdata["train_indices"]), sc["images"].shape[1:3],
                          torch.Generator().manual_seed(13), dev)
    for a, b in zip((draws.slot, draws.py, draws.px, draws.jitter, draws.sparse_points),
                    (rdraws["slot"], rdraws["py"], rdraws["px"], rdraws["jitter"],
                     rdraws["sparse"])):
        assert torch.equal(a, b)
    lv = leaves(params)
    for _, t in lv:
        t.requires_grad_(True)
    total, _ = RM.loss(params, rdata, cfg, rdraws, step)
    grads = torch.autograd.grad(total, [t for _, t in lv], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(lv, grads)]
    assert float(total) == pytest.approx(float(metrics["total_loss"]), rel=1e-6)
    Optimizer(cfg).step(lv, grads, step)
    prog = dict(leaves(state.params))
    for path, t in lv:
        torch.testing.assert_close(prog[path].detach(), t.detach(), rtol=1e-5, atol=1e-7,
                                   msg=path)


@pytest.mark.parametrize("workload", tiny.workloads())
def test_controls_exceed_the_limits(root, workload):
    """The reference in the precision below the stated one, and with half
    of the rays left out, each fail a number at the cell's limits; a
    frozen state reads 1 on the change."""
    cell = harness.cell(workload, root)
    limits = json.loads((tiny.REPO / "port_bench" / "limits" / f"{workload}.json").read_text())
    r = control.readings(cell, 21, list(control.FAULTS), torch.device("cpu"))
    for fault in ("lower", "keep_half"):
        assert not check.verdict(r[fault], limits), (fault, r[fault])
    assert r["frozen"]["change_gap"] == pytest.approx(1.0)
