"""What decides ``correct``: the plain reference follows the checked steps of
the program's run from the same inputs, and three numbers are compared,
each with its limit from ``limits/<workload>.json``:

* ``loss_gap``: the largest relative gap of a checked step's loss, over
  the steps and scenes;
* ``grad_gap``: the worst leaf's gap between the norm of its first
  gradient as the program's optimizer got it (its first moment after one
  step over 1 - b1) and the reference's, relative to the larger of that
  leaf's reference norm and the median leaf's;
* ``change_gap``: the same of the norm of each leaf's change over the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (below that a leaf moves under Adam by
  rounding alone).

The reference runs after the window, after the peak memory is read and the
program's state is freed, a scene at a time, in float32 with TF32 off and
the MLP matmuls in the configuration's compute dtype.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from . import drive, weights
from .reference import model as RM
from .reference.optim import Optimizer, leaves

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
GRAD_FLOOR = 1e-3  # of the median leaf's first gradient: leaves below it are left out of the change


def ref_data(scene: dict, cfg: dict, traffic: dict, dev) -> dict:
    """The reference's own tensors of a scene dict, and its train cameras
    worked out again from the split and the image cap."""
    n = scene["images"].shape[0]
    idx = drive.subsample(drive.train_indices_for(n, drive.split_of(cfg, traffic)),
                          cfg["max_train_images"])

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    cams = {"camera_to_worlds": torch.as_tensor(np.asarray(scene["poses"], np.float32),
                                                device=dev),
            "fx": full(float(scene["fx"])), "fy": full(float(scene["fy"])),
            "cx": full(float(scene["cx"])), "cy": full(float(scene["cy"])),
            "width": full(int(scene["width"]), torch.int64),
            "height": full(int(scene["height"]), torch.int64),
            "distortion": torch.zeros((n, 6), device=dev)}
    return {"images": torch.as_tensor(scene["images"], device=dev),
            "masks": torch.as_tensor(scene["masks"], device=dev),
            "cameras": cams, "train_indices": torch.as_tensor(idx, device=dev)}


def reference_steps(cfg: dict, traffic: dict, scene: dict, params: dict, draw_seed: int,
                    steps: int, dev, lower: bool = False, keep_half: bool = False,
                    frozen: bool = False) -> dict:
    """The reference's checked steps of one scene from ``params``: each
    step's loss, each leaf's first-gradient norm, each leaf's change norm
    after the steps, and the positions of step 1's grid calls. Planted
    faults for the controls: ``lower`` (the precision below the stated),
    ``keep_half`` (half of the rays left out, the mean over the rest),
    ``frozen`` (every step returns the state unchanged)."""
    data = ref_data(scene, cfg, traffic, dev)
    hw = tuple(scene["images"].shape[1:3])
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    p0 = {path: t.detach().clone() for path, t in leaves(params)}
    for _, t in leaves(params):
        t.requires_grad_(True)
    opt = Optimizer(cfg)
    step = traffic["start_step"]
    out = {"losses": [], "grad_norms": {}, "positions": []}
    for i in range(steps):
        draws = RM.draw_step(cfg, len(data["train_indices"]), hw, gen, dev)
        keep = None
        if keep_half:
            keep = torch.arange(cfg["train_rays_per_batch"], device=dev) % 2 == 0
        record = out["positions"] if i == 0 else None
        total, _ = RM.loss(params, data, cfg, draws, step, lower, record, keep)
        lv = leaves(params)
        grads = torch.autograd.grad(total, [t for _, t in lv], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(lv, grads)]
        out["losses"].append(float(total.detach().double()))
        if i == 0:
            out["grad_norms"] = {path: float(torch.linalg.vector_norm(g.double()))
                                 for (path, _), g in zip(lv, grads)}
        if not frozen:
            opt.step(lv, grads, step)
        step += 1
        del total, grads
    out["change_norms"] = {path: float(torch.linalg.vector_norm((t.detach() - p0[path]).double()))
                           for path, t in leaves(params)}
    return out


def _gap(a: float, b: float, scale: float) -> float:
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else float("inf"))


def numbers(prog: list[dict], ref: list[dict], where: dict | None = None) -> dict:
    """The compared numbers over scenes: each side a dict per scene of
    losses [step], grad_norms {path}, change_norms {path}. ``where``, if
    given, gets the scene and step or leaf that sets each number."""
    out = {k: 0.0 for k in NUMBERS}
    at = {k: None for k in NUMBERS}

    def keep(k, v, place):
        if v > out[k] or (np.isnan(v) and not np.isnan(out[k])):
            out[k], at[k] = v, place

    for s, (p, r) in enumerate(zip(prog, ref)):
        for i, (lp, lr) in enumerate(zip(p["losses"], r["losses"])):
            keep("loss_gap", _gap(lp, lr, abs(lr)), (s, i))
        med = statistics.median(r["grad_norms"].values())
        for path, gr in r["grad_norms"].items():
            keep("grad_gap", _gap(p["grad_norms"][path], gr, max(gr, med)), (s, path))
        moved = {k: v for k, v in r["change_norms"].items() if r["grad_norms"][k] >= GRAD_FLOOR * med}
        cmed = statistics.median(moved.values())
        for path, cr in moved.items():
            keep("change_gap", _gap(p["change_norms"][path], cr, max(cr, cmed)), (s, path))
    if where is not None:
        where.update(at)
    return out


def program_side(res: drive.Result, cfg: dict, dev) -> list[dict]:
    """The program's numbers per scene, its change worked out against the
    initial parameters made again from the seed."""
    c = res.checked
    s = c.scenes
    p0 = weights.make(cfg, res.info["num_images"], res.inputs["seeds"]["weights"], dev, scenes=s)
    losses = c.loss_values()
    out = []
    for k in range(1 if s is None else s):
        change = {}
        for path, t in leaves(p0):
            after = c.after[path].to(dev)
            d = (after - t) if s is None else (after[k] - t[k])
            change[path] = float(torch.linalg.vector_norm(d.double()))
        out.append({"losses": [step[k] for step in losses],
                    "grad_norms": {path: v[k] for path, v in c.grad_norms.items()},
                    "change_norms": change})
    return out


def reference_side(res: drive.Result, cfg: dict, traffic: dict, dev, **fault) -> list[dict]:
    """The reference's numbers per scene (a scene at a time, each from its
    own slice of the initial parameters and its own draws)."""
    s = res.checked.scenes
    n = res.info["num_images"]
    out = []
    for k, scene in enumerate(res.inputs["scenes"]):
        p = weights.make(cfg, n, res.inputs["seeds"]["weights"], dev, scenes=s)
        if s is not None:
            p = _index(p, k)
        out.append(reference_steps(cfg, traffic, scene, p, res.inputs["seeds"]["draws"] + (
            0 if s is None else k), res.checked.steps, dev, **fault))
        del p
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return out


def _index(tree, k):
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, k) for v in tree]
    return tree[k].clone()


def verdict(nums: dict, limits: dict) -> bool:
    """Every number compared has its limit and is finite and within it."""
    return bool(nums) and set(nums) == set(limits) and all(
        np.isfinite(v) and v <= limits[k] for k, v in nums.items())


def precision_for_reference():
    """float32 matmuls in full float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
