"""Entry ``semantic_nerf_loop``: the ``train_loop`` entry (one scene through
``engine/trainer.py:train_loop`` from a state at the traffic's
``start_step``, a log every ``steps_per_log`` steps, no eval, no
checkpoint) for a configuration whose main field is the reference's
``SemanticNeRFField``: its initial parameters, its comparison with the
plain reference and its counted least work come from
``port_bench/semantic_nerf.py``."""
from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from port_bench import check, drive, harness, scene as SC, semantic_nerf as SNB
from port_bench.harness import load_entry


class Entry(load_entry("train_loop")):
    def __init__(self, cell, seed_parts, dev, cfg_check: bool):
        from fruitnerf_tpu_torch.data.builder import dataset_from_scene
        from fruitnerf_tpu_torch.engine.trainer import init_train_state, subsample_train_images
        from fruitnerf_tpu_torch.utils.writer import MetricWriter

        t = cell.traffic
        (sp,) = drive.scene_params(t, seed_parts["scene"])
        self.scenes = None
        self.scene_list = [SC.render(sp, dev)]
        self.seed_parts = seed_parts
        n = sp["num_cameras"]
        cfg_d = harness.run_config(cell)
        self.config = drive.program_config(cell, n, strict=cfg_check)
        data = dataset_from_scene(self.scene_list[0], dev, train_fraction=drive.split_of(cfg_d, t))
        if self.config.max_train_images is not None:
            data = subsample_train_images(data, self.config.max_train_images)
        self.data = data
        self.state = init_train_state(self.config, n, dev,
                                      params=SNB.make(cfg_d, n, seed_parts["weights"], dev))
        self.state.step = t["start_step"]
        self.generator = torch.Generator(device=dev).manual_seed(seed_parts["draws"])
        self.tmp = tempfile.TemporaryDirectory(prefix="port_bench_")
        self.writer = MetricWriter(Path(self.tmp.name) / "metrics.jsonl", also_print=False)
        self.units_per_step = self.config.train_rays_per_batch
        self.begin(t)

    @staticmethod
    def compare(res, cfg: dict, traffic: dict, dev, where: dict) -> tuple[dict, list]:
        """The compared numbers (``check.numbers``) of the program against
        this field's reference, run after the program's state is freed."""
        check.precision_for_reference()
        prog = SNB.program_side(res, cfg, dev)
        ref = SNB.reference_side(res, cfg, traffic, dev)
        return check.numbers(prog, ref, where), ref

    @staticmethod
    def least_work(res, cfg: dict, ref: list) -> dict:
        """``semantic_nerf.window_least`` over the traced window's steps."""
        steps = range(res.trace_first_step, res.trace_first_step + res.trace.steps)
        return SNB.window_least(cfg, res.info["num_images"], steps)
