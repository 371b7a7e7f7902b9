"""Multi-scene batched training: S structurally identical scenes (same image
resolution, camera count and train split) trained by one step. Twin of
``fruitnerf_tpu/parallel/multi_scene.py``, which vmaps its fused train step
over a scene axis; there a vmap of a ``pallas_call`` prepends the scene
axis to the kernel's grid.

Here the step is ``torch.func.vmap(torch.func.grad_and_value(loss))`` over
the stacked parameters, the stacked ``DeviceDataset`` fields (cameras
included) and the stacked draws. The grid encodings' autograd Functions
have ``vmap`` rules that launch each CUDA kernel once for all scenes
(``ops/hash_grid.py``), so one host launch sequence drives S scenes of
device work; the card idles most of an eager single-scene step (PERF.md),
which is what this buys back. One optimizer steps the stacked leaves: Adam
and RAdam are elementwise, so that is S independent optimizers.

Each scene has its own generator (the twin's ``jax.random.split``), from
which its parameters and then its draws are made, outside the transform
(the twin folds the scene into the step's key); draws can be injected, as
for ``train_step``. ``make_multi_scene_chunk``'s ``lax.scan`` is not
ported: a chunk equals its single steps.

The step is ``train_step``'s twin in how it runs too
(``engine/step_graph.py:run_step``): it reads its scalars from the device
(``trainer.StepScalars``) and, on the card from a state's second step,
replays the CUDA graph captured for its proposal gate: the S scenes' draws,
with every scene's generator registered, the vmapped loss and gradient and
the optimizer, so that the card and not the host's dispatch sets the pace.
Given draws and scene groups on two or more devices run eagerly.

Use: counting campaigns over many scenes (``scripts/multi_scene_campaign.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..bridge import index_tree, stack_trees, tree_leaves, tree_map, zip_trees
from ..cameras.camera_opt import init_camera_opt
from ..cameras.cameras import Cameras
from ..configs import TrainConfig
from ..engine.step_graph import run_step
from ..engine.trainer import (
    DeviceDataset,
    StepDraws,
    TrainState,
    camera_opt_metrics,
    compute_loss,
    draw_step,
    make_optimizer,
    optimizer_step,
    step_metrics,
)
from ..models.fruit_model import init_fruit_model
from ..utils.profiling import span


def stack_datasets(datasets: list[DeviceDataset]) -> DeviceDataset:
    """Stack S structurally identical datasets along a new scene axis."""
    shapes = {tuple(d.images.shape) for d in datasets}
    if len(shapes) != 1:
        raise ValueError(
            f"multi-scene training needs identical image stacks, got {shapes}"
        )
    counts = {tuple(d.train_indices.shape) for d in datasets}
    if len(counts) != 1:
        raise ValueError(
            f"multi-scene training needs identical train splits, got {counts}"
        )
    return _dataset(stack_trees([_fields(d) for d in datasets]))


def scene_dataset(datas: DeviceDataset, s: int) -> DeviceDataset:
    """Scene ``s`` of a stacked dataset (views)."""
    return _dataset(index_tree(_fields(datas), s))


def _fields(data: DeviceDataset) -> dict:
    """A dataset as a tree of tensors, which torch.func maps over."""
    cams = {f.name: getattr(data.cameras, f.name) for f in dataclasses.fields(Cameras)}
    return {"images": data.images, "masks": data.masks, "cameras": cams,
            "train_indices": data.train_indices}


def _dataset(fields: dict) -> DeviceDataset:
    return DeviceDataset(images=fields["images"], masks=fields["masks"],
                         cameras=Cameras(**fields["cameras"]),
                         train_indices=fields["train_indices"])


def _draw_fields(draws: StepDraws) -> dict:
    return {f.name: getattr(draws, f.name) for f in dataclasses.fields(StepDraws)}


def scene_generators(config: TrainConfig, num_scenes: int, device) -> list[torch.Generator]:
    """One generator a scene, seeded from ``config.seed`` (the twin's
    ``jax.random.split(key, S)``): scene s's seed is the s-th child of a
    numpy ``SeedSequence`` of the config's seed."""
    seeds = np.random.SeedSequence(config.seed).spawn(num_scenes)
    return [torch.Generator(device=device).manual_seed(int(s.generate_state(1, np.uint64)[0]))
            for s in seeds]


def init_multi_scene_state(
    config: TrainConfig, num_cameras: int, num_scenes: int, device,
    generators: list[torch.Generator] | None = None, params: dict | None = None,
) -> tuple[TrainState, list[torch.Generator]]:
    """-> (a train state whose parameter leaves are [S, ...] stacks, scene s
    initialised from its own generator; the generators, which go on to make
    the scenes' draws). ``params``: stacked parameters to start from
    instead (for example ``bridge.scene_params_from_jax``)."""
    if generators is None:
        generators = scene_generators(config, num_scenes, device)
    if params is None:
        params = stack_trees([
            {"model": init_fruit_model(config.model, g, device),
             "camera_opt": init_camera_opt(num_cameras, device)}
            for g in generators
        ])
    # torch.func takes the gradients; the leaves need none of their own
    params = tree_map(params, lambda t: t.detach())
    return TrainState(params=params, optimizer=make_optimizer(params, config)), generators


def _step_fn(config: TrainConfig, state: TrainState):
    """(params, dataset fields, draw fields) of one scene -> (total loss,
    (losses, metrics)), for grad_and_value, at ``state``'s step and staged
    scalars, which every scene shares."""

    def loss(params, fields, draws):
        scene = TrainState(params=params, optimizer=None, step=state.step, scalars=state.scalars)
        total, losses, metrics = compute_loss(scene, _dataset(fields), config, StepDraws(**draws))
        return total, (losses, metrics)

    return vmap(grad_and_value(loss, has_aux=True))


def _groups(num_scenes: int, devices, home) -> list[tuple[slice, torch.device]]:
    """Contiguous scene groups, one a device (the twin shards the scene
    axis over its mesh); one group on ``home`` without devices."""
    if not devices or len(devices) < 2:
        return [(slice(0, num_scenes), home)]
    bounds = np.linspace(0, num_scenes, min(len(devices), num_scenes) + 1).round().astype(int)
    return [(slice(int(a), int(b)), torch.device(d))
            for a, b, d in zip(bounds[:-1], bounds[1:], devices)]


def multi_scene_step(
    state: TrainState,
    datas: DeviceDataset,
    config: TrainConfig,
    generators: list[torch.Generator] | None = None,
    draws: list[StepDraws] | None = None,
    devices=None,
) -> dict[str, torch.Tensor]:
    """One train step of every scene: draws (each scene's from its generator
    unless given), one vmapped loss and gradient, one optimizer step.
    Updates ``state`` in place and returns the metrics as [S] tensors.

    ``devices`` (a list of at least two): the scenes split into contiguous
    groups, one a device, each group's step on its device (the parameters'
    group slice and its data there, its gradients and metrics back); the
    parameters and the optimizer stay on the state's device.

    The step reads its scalars from the parameters' device, and on the
    card a step that draws from ``generators`` on one group of scenes
    replays the step captured for its proposal gate
    (``step_graph.run_step``), the same work on the same tensors."""
    groups = _groups(datas.images.shape[0], devices, None)
    return run_step(state, datas, config, generators,
                    lambda count: _step(state, datas, config, generators, draws, devices, count),
                    eager=draws is not None or len(groups) > 1)


def _step(state, datas, config, generators, draws, devices, count=True) -> dict:
    """``multi_scene_step``'s work on its staged scalars; ``count``: as in
    ``optimizer_step``."""
    num_scenes = datas.images.shape[0]
    with span("draws"):
        if draws is None:
            draws = [draw_step(config, scene_dataset(datas, s), generators[s])
                     for s in range(num_scenes)]
        if len(draws) != num_scenes:
            raise ValueError(f"{len(draws)} scenes of draws for {num_scenes} scenes")
        draw_fields = stack_trees([_draw_fields(d) for d in draws])
    fields = _fields(datas)
    fn = _step_fn(config, state)
    home = datas.images.device
    grads, totals, losses, metrics = [], [], [], []

    def cat(trees):
        return trees[0] if len(trees) == 1 else zip_trees(trees, torch.cat)

    # the forward stages' spans open inside this one; its self time is the
    # backward's and the transforms' host time
    with span("loss_and_grad"):
        for sl, dev in _groups(num_scenes, devices, home):
            def part(tree, sl=sl, dev=dev):  # views where the group is at home
                return tree_map(tree, lambda t: t[sl].to(dev))

            g, (total, (ls, ms)) = fn(part(state.params), part(fields), part(draw_fields))
            for out, tree in ((grads, g), (totals, total), (losses, ls), (metrics, ms)):
                out.append(tree_map(tree, lambda t: t.to(home)))
        for p, g in zip(tree_leaves(state.params), tree_leaves(cat(grads))):
            p.grad = g
    with span("optimizer"):
        if count:  # an eager step's call keeps its signature: the benchmark's fault tests patch it
            optimizer_step(state, config)
        else:
            optimizer_step(state, config, count=False)
    with span("metrics"):
        out = step_metrics(cat(metrics), cat(losses), cat(totals))
        if config.use_camera_opt:
            out.update(camera_opt_metrics(state.params["camera_opt"], dims=(1, 2)))
        return out
