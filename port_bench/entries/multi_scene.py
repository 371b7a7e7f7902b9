"""Entry ``multi_scene``: the traffic's ``scenes`` through
``parallel/multi_scene.py:multi_scene_step`` in a loop, as
``scripts/multi_scene_campaign.py:main`` drives it, from a state at the
traffic's ``start_step``."""
from __future__ import annotations

import torch

from port_bench import drive, harness, scene as SC, weights
from port_bench.training import TrainingEntry


class Entry(TrainingEntry):
    def __init__(self, cell, seed_parts, dev, cfg_check: bool):
        from fruitnerf_tpu_torch.data.builder import dataset_from_scene
        from fruitnerf_tpu_torch.parallel.multi_scene import (
            init_multi_scene_state,
            stack_datasets,
        )

        t = cell.traffic
        sps = drive.scene_params(t, seed_parts["scene"])
        self.scenes = len(sps)
        self.scene_list = [SC.render(sp, dev) for sp in sps]
        self.seed_parts = seed_parts
        n = sps[0]["num_cameras"]
        cfg_d = harness.run_config(cell)
        self.config = drive.program_config(cell, n, strict=cfg_check)
        split = drive.split_of(cfg_d, t)
        self.datas = stack_datasets([dataset_from_scene(s, dev, train_fraction=split)
                                     for s in self.scene_list])
        params = weights.make(cfg_d, n, seed_parts["weights"], dev, scenes=self.scenes)
        self.generators = [torch.Generator(device=dev).manual_seed(seed_parts["draws"] + s)
                           for s in range(self.scenes)]
        self.state, _ = init_multi_scene_state(self.config, n, self.scenes, dev,
                                               generators=self.generators, params=params)
        self.state.step = t["start_step"]
        self.units_per_step = self.config.train_rays_per_batch * self.scenes
        self.begin(t)

    def run(self, on_step, stop):
        from fruitnerf_tpu_torch.parallel.multi_scene import multi_scene_step

        while True:
            metrics = multi_scene_step(self.state, self.datas, self.config, self.generators)
            on_step(self.state, metrics)
            if stop():
                return
