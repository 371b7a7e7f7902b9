"""Entry ``train_loop``: one scene through ``engine/trainer.py:train_loop``
from a state at the traffic's ``start_step`` (as a resume sets it), logging
every ``steps_per_log`` steps into a ``MetricWriter`` under ``$TMPDIR``, no
eval and no checkpoint; a callback passed through the loop's ``callbacks``
ends it."""
from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from port_bench import drive, harness, scene as SC, weights
from port_bench.training import TrainingEntry


class StopLoop(Exception):
    """Raised by a callback to end ``train_loop``."""


class Entry(TrainingEntry):
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
        params = weights.make(cfg_d, n, seed_parts["weights"], dev)
        self.state = init_train_state(self.config, n, dev, params=params)
        self.state.step = t["start_step"]
        self.generator = torch.Generator(device=dev).manual_seed(seed_parts["draws"])
        self.tmp = tempfile.TemporaryDirectory(prefix="port_bench_")
        self.writer = MetricWriter(Path(self.tmp.name) / "metrics.jsonl", also_print=False)
        self.units_per_step = self.config.train_rays_per_batch
        self.begin(t)

    def run(self, on_step, stop):
        from fruitnerf_tpu_torch.engine.trainer import train_loop

        def cb(it, state, metrics):
            on_step(state, metrics)
            if stop():
                raise StopLoop

        try:
            train_loop(self.config, self.data, state=self.state, generator=self.generator,
                       writer=self.writer, callbacks=(cb,))
        except StopLoop:
            pass

    def close(self):
        self.writer.close()
        self.tmp.cleanup()
