"""``run_step``, the one function that runs a train step:
``trainer.train_step``'s work, or ``parallel/multi_scene.py:
multi_scene_step``'s over every scene, on the scalars ``trainer.StepScalars``
stages before each step, on every device. On the card a step is captured as a CUDA graph once a key (the
proposal gate: whether the proposal nets train) and replayed on every later
step with that key, so that the card and not the host's dispatch of a few
hundred launches sets a step's pace.

A captured step reads everything that changes between steps from the
device: the draws from its generators (one, or one a scene), each
registered with the graph (each replay consumes each generator's Philox
offsets as an eager step does), and the staged scalars. The parameters, the
optimizer's state and the staged scalars live outside the graphs' memory
pool; nothing in the pool outlives a replay, so the graphs of every key
share one pool. The host code of a capture runs once and launches
nothing: the grid kernels' launch counts (``ops/hash_grid.py``) move from
the capture to each replay.
"""
from __future__ import annotations

import torch

from ..models.fruit_model import proposal_anneal, proposal_updated
from ..ops import hash_grid as hg
from ..utils.profiling import span
from .trainer import _parts, count_step, graph_reads, stage_scalars


def run_step(state, data, config, generators, work, eager: bool = False) -> dict:
    """One train step -> its metrics. Stages the step's scalars
    (``trainer.stage_scalars``); then, where ``replay_key`` gives the step
    a key, replays the step that ``work(False)`` makes (captured once a key,
    uncounted) and counts it (``trainer.count_step``); else runs
    ``work(True)``, which counts itself. ``data``: the (stacked) dataset
    and ``generators``: those the step draws from; ``eager``: the caller's
    reason to run eagerly (given draws, a mesh, scene groups on two or more
    devices)."""
    stage_scalars(state, config)
    key = replay_key(state, config, eager)
    if key is None:
        if state.graphs is None and state.scalars.buffer.is_cuda:
            state.graphs = StepGraphs()  # this step does torch's lazy set-up; later ones may replay
        return work(True)
    metrics = state.graphs.run(key, graph_reads(state, data, config, generators), generators,
                               lambda: work(False))
    count_step(state)
    return metrics


def replay_key(state, config, eager: bool = False):
    """Which captured step replays a step: (its proposal gate, whether the
    anneal still runs); None where the step runs eagerly: off a card or on
    a state's first step there (``state.graphs`` is None), ``eager``, or an
    optimizer without state (a captured step must not create it, or it
    would live in the graph's memory)."""
    if eager or state.graphs is None or not all(
            len(opt.state) == sum(len(g["params"]) for g in opt.param_groups)
            for opt in _parts(state.optimizer)):
        return None
    mc = config.model
    return proposal_updated(state.step, mc), proposal_anneal(state.step, mc) != 1.0


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
