"""The reference's optimizer: per-group Adam or RAdam on plain tensors.

Frozen copy of the mathematics of ``fruitnerf_tpu_torch/engine/trainer.py``
(``learning_rate``, ``_group_params``, ``_group_configs``, ``RAdam``) and of
``torch.optim.Adam``'s update with decoupled weight decay, as of the
benchmark's first version. Every update is elementwise, so a leaf with a
leading scene axis is S independent optimizers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

B1, B2 = 0.9, 0.999
RADAM_THRESHOLD = 5.0
GROUPS = ("fields", "appearance", "proposal_networks", "camera_opt")
GROUP_OPT = {"fields": "fields_opt", "appearance": "appearance_opt",
             "proposal_networks": "proposal_opt", "camera_opt": "camera_opt"}


def leaves(tree, prefix=""):
    """[(path, tensor)] of a parameter tree: dicts by sorted key, lists in
    order (the program's canonical order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def group_of(path: str) -> str:
    if path.startswith("/camera_opt"):
        return "camera_opt"
    if path.startswith("/model/proposal_networks"):
        return "proposal_networks"
    if path == "/model/field/appearance":
        return "appearance"
    return "fields"


def learning_rate(opt: dict, step: int, max_iters: int) -> float:
    if step < opt["warmup_steps"]:
        return 0.0
    count = step - opt["warmup_steps"]
    steps = opt["max_steps"] or max_iters
    return opt["lr_init"] * (opt["lr_final"] / opt["lr_init"]) ** (count / steps)


def radam_scalars(count: int):
    f32 = np.float32
    t = f32(count)
    b2t = f32(B2) ** t
    ro_inf = 2.0 / (1.0 - B2) - 1.0
    ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
    r = None
    if ro >= f32(RADAM_THRESHOLD):
        num = (ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
        r = float(np.sqrt(num / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
    return float(f32(1) - f32(B1) ** t), float(f32(1) - b2t), r


class Optimizer:
    """Adam or RAdam per group, its moments per leaf path."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.m: dict[str, torch.Tensor] = {}
        self.v: dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: list, grads: list, step: int):
        """One update of every leaf ([(path, tensor)]) in place by its
        gradient; ``step`` is the train step the schedules read."""
        self.count += 1
        t = self.count
        for (path, p), g in zip(params, grads):
            opt = self.cfg[GROUP_OPT[group_of(path)]]
            lr = learning_rate(opt, step, self.cfg["max_iters"])
            m = self.m.setdefault(path, torch.zeros_like(p))
            v = self.v.setdefault(path, torch.zeros_like(p))
            if opt["name"] == "adam":
                m.lerp_(g, 1.0 - B1)
                v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
                if opt["weight_decay"]:
                    p.mul_(1.0 - lr * opt["weight_decay"])
                bc1, bc2 = 1.0 - B1**t, 1.0 - B2**t
                denom = (v.sqrt() / math.sqrt(bc2)).add_(opt["eps"])
                p.addcdiv_(m, denom, value=-lr / bc1)
            elif opt["name"] == "radam":
                m.mul_(B1).add_(g * (1.0 - B1))
                v.mul_(B2).add_(g * g * (1.0 - B2))
                bc1, bc2, r = radam_scalars(t)
                upd = m / bc1
                if r is not None:
                    upd = upd * r / ((v / bc2).sqrt() + opt["eps"])
                upd = upd * -lr
                if opt["weight_decay"]:
                    upd = upd - p * (opt["weight_decay"] * lr)
                p.add_(upd)
            else:
                raise ValueError(f"unknown optimizer {opt['name']!r}")
