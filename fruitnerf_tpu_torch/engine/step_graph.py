"""The train step on the card as CUDA graphs: ``trainer.train_step``'s work,
or ``parallel/multi_scene.py:multi_scene_step``'s over every scene,
captured once a key (the proposal gate: whether the proposal nets train)
and replayed on every later step with that key, so that the card and not
the host's dispatch of a few hundred launches sets a step's pace.

A captured step reads everything that changes between steps from the
device: the draws from its generators (one, or one a scene), each
registered with the graph (each replay consumes each generator's Philox
offsets as an eager step does), and the scalars that
``trainer.StepScalars`` stages before each step. The parameters, the
optimizer's state and the staged scalars live outside the graphs' memory
pool; nothing in the pool outlives a replay, so the graphs of every key
share one pool. The host code of a capture runs once and launches
nothing: the grid kernels' launch counts (``ops/hash_grid.py``) move from
the capture to each replay.
"""
from __future__ import annotations

import torch

from ..ops import hash_grid as hg
from ..utils.profiling import span


class StepGraphs:
    """Captured steps, one a key, valid while the objects they were captured
    on stay the same."""

    def __init__(self):
        self.graphs: dict = {}
        self.reads: tuple = ()
        self.pool = None

    def run(self, key, reads: tuple, generators, step) -> dict:
        """Replay the step captured for ``key`` (capturing ``step()``, which
        returns the step's metrics, first) -> the metrics. ``generators``:
        the ``torch.Generator``s the step draws from. ``reads``: what the
        step reads and writes; if any of it is another object than at
        the captures, every graph is dropped first."""
        if len(reads) != len(self.reads) or any(a is not b for a, b in zip(reads, self.reads)):
            self.graphs.clear()
            self.pool = None
            self.reads = reads
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CapturedStep(step, generators, self.pool)
            self.pool = graph.graph.pool()
        with span("graph"):
            return graph.replay()


class CapturedStep:
    """One step's CUDA graph, its metrics (scalars, or [S] vectors of a
    multi-scene step) packed into one device tensor."""

    def __init__(self, step, generators, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        launches, scenes = dict(hg.LAUNCHES), dict(hg.SCENES)
        with span("graph.capture"), torch.cuda.graph(self.graph, pool=pool):
            metrics = step()
            self.names = list(metrics)
            self.packed = torch.stack([metrics[k].float() for k in self.names])
        self.launches = {k: hg.LAUNCHES[k] - n for k, n in launches.items()}
        self.scenes = {k: hg.SCENES[k] - n for k, n in scenes.items()}
        hg.LAUNCHES.update(launches)
        hg.SCENES.update(scenes)

    def replay(self) -> dict:
        """Run the step -> its metrics, one copy of the packed tensor that
        later replays leave alone."""
        self.graph.replay()
        for k, n in self.launches.items():
            hg.LAUNCHES[k] += n
            hg.SCENES[k] += self.scenes[k]
        return dict(zip(self.names, self.packed.clone().unbind()))
