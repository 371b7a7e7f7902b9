"""What the training entries (``entries/train_loop.py``,
``entries/multi_scene.py``) share: the record of the checked steps that the
reference follows, the end-to-end rate, the comparison that decides
``correct`` and the counted least work of the traced window.

An entry class (``entries/<name>.py``: ``Entry``) gives ``drive.run_cell``
``step`` (steps issued so far), ``units_per_step``, ``run(on_step, stop)``
with ``on_step(state, metrics)``, ``record`` and ``observe`` (what a
warm-up and a window step keep), ``finite()``, ``describe()``,
``inputs()`` and ``close()``; and ``run.py`` the class methods ``values``,
``compare`` and ``least_work``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import check, counts
from .reference.optim import leaves

B1 = 0.9  # Adam's and RAdam's first-moment decay: exp_avg = (1 - B1) * grad after one step


def _exp_avgs(optimizer) -> dict:
    parts = optimizer.parts.values() if hasattr(optimizer, "parts") else [optimizer]
    return {id(p): st["exp_avg"] for o in parts for p, st in o.state.items()}


def _norms(t: torch.Tensor, scenes: int | None) -> list[float]:
    """The float64 norm of a leaf, or of each scene's slice."""
    t = t.detach().double()
    if scenes is None:
        return [float(torch.linalg.vector_norm(t))]
    return [float(x) for x in torch.linalg.vector_norm(t.reshape(scenes, -1), dim=1)]


@dataclasses.dataclass
class Checked:
    """The program's numbers over the checked steps, per scene: each
    step's loss, each leaf's first gradient (from the optimizer's state
    after step 1) and its parameters after the last checked step."""

    scenes: int | None
    steps: int
    losses: list = dataclasses.field(default_factory=list)  # [step] -> tensor
    grad_norms: dict = dataclasses.field(default_factory=dict)  # path -> [scene]
    after: dict = dataclasses.field(default_factory=dict)  # path -> host tensor

    def record(self, state, metrics):
        n = len(self.losses)
        if n >= self.steps:
            return
        self.losses.append(metrics["total_loss"].detach().clone())
        if n == 0:
            # a leaf without optimizer state got no gradient: its norm reads 0
            avgs = _exp_avgs(state.optimizer)
            self.grad_norms = {
                path: _norms(avgs.get(id(t), torch.zeros_like(t)) / (1.0 - B1), self.scenes)
                for path, t in leaves(state.params)}
        if n == self.steps - 1:
            self.after = {path: t.detach().to("cpu", copy=True) for path, t in leaves(state.params)}

    def loss_values(self) -> list[list[float]]:
        """[step][scene] losses."""
        return [[float(x) for x in t.double().reshape(-1).cpu()] for t in self.losses]


class TrainingEntry:
    """The shared half of a training entry. A subclass's ``__init__`` makes
    ``state`` (with ``params``, ``optimizer`` and ``step``), ``scenes``
    (None for one scene, else their number), ``scene_list``,
    ``seed_parts`` and ``units_per_step`` (rays a step over every scene),
    then calls ``begin(traffic)``; it defines ``run`` and may define
    ``close``."""

    unit_metric = "train_rays_per_s"

    def begin(self, traffic: dict):
        self.checked = Checked(self.scenes, traffic["checked_steps"])
        self.last = None

    @property
    def step(self) -> int:
        return self.state.step

    def record(self, state, metrics):
        self.checked.record(state, metrics)
        self.last = metrics

    def observe(self, state, metrics):
        self.last = metrics

    def finite(self) -> bool:
        return bool(torch.isfinite(self.last["total_loss"]).all())

    def describe(self) -> dict:
        return {"num_images": len(self.scene_list[0]["poses"])}

    def inputs(self) -> dict:
        return {"scenes": self.scene_list, "seeds": self.seed_parts}

    def close(self):
        pass

    @classmethod
    def values(cls, res) -> dict:
        """The entry's end-to-end metrics other than ``setup_s``: every ray
        of the window over its wall time."""
        return {cls.unit_metric: res.units / res.window_s}

    @staticmethod
    def compare(res, cfg: dict, traffic: dict, dev, where: dict) -> tuple[dict, list]:
        """The compared numbers (``check.py``) and the reference's record,
        run after the program's state is freed."""
        check.precision_for_reference()
        prog = check.program_side(res, cfg, dev)
        ref = check.reference_side(res, cfg, traffic, dev)
        return check.numbers(prog, ref, where), ref

    @staticmethod
    def least_work(res, cfg: dict, ref: list) -> dict:
        """``counts.window_least`` over the traced window's steps, at the
        distinct rows that the reference's step-1 grid positions touch."""
        touched = [{name: counts.touched_rows(lay, pos) for name, lay, pos in r["positions"]}
                   for r in ref]
        steps = range(res.trace_first_step, res.trace_first_step + res.trace.steps)
        return counts.window_least(cfg, res.info["num_images"], touched, steps)
