"""Training engine: device-resident data, the train step, per-group Adam or
RAdam, the chunked eval render, eval metrics and the outer ``train_loop``.
Twin of ``fruitnerf_tpu/engine/trainer.py``.

Every random draw of a step is made in one place, ``draw_step``, from an
explicit ``torch.Generator``; ``train_step`` takes the draws, so a test can
inject the JAX step's draws instead.

A train step reads its per-step scalars (the learning rates, the
optimizers' bias corrections, RAdam's rectifier, the proposal anneal) from
the parameters' device (``StepScalars``), on every device alike; on the card
a step that draws from its generator is replayed from a CUDA graph captured
once per proposal-gate value (``step_graph.py``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import signal
import threading
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..bridge import tree_leaves, tree_map
from ..cameras.camera_opt import exp_map_so3xr3, init_camera_opt
from ..cameras.cameras import Cameras, frustum_coverage, generate_image_rays, generate_rays
from ..configs import OptimizerConfig, TrainConfig
from ..core.rays import near_far_collider
from ..models.fruit_model import (
    field_density,
    forward_collided,
    forward_train,
    init_fruit_model,
    loss_dict,
    metrics_dict,
    proposal_anneal,
    sampler_draw_shapes,
)
from ..utils import metrics as M
from ..utils.profiling import span
from .checkpoints import save_checkpoint, save_checkpoint_async

if TYPE_CHECKING:
    from .step_graph import StepGraphs


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    """The whole training set on the device; uint8 keeps it small and pixels
    become float32 after the gather."""

    images: torch.Tensor  # [N, H, W, 3] uint8
    masks: torch.Tensor  # [N, H, W] uint8 (0/1)
    cameras: Cameras
    train_indices: torch.Tensor  # [T] int64

    @property
    def image_shape(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]


def build_device_dataset(
    images: np.ndarray,  # [N,H,W,3] float (0..1) or uint8
    masks: np.ndarray,  # [N,H,W] float (0/1) or uint8
    cameras: Cameras,
    train_indices: np.ndarray,
    device,
) -> DeviceDataset:
    if images.dtype != np.uint8:
        images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    if masks.dtype != np.uint8:
        masks = (masks > 0.5).astype(np.uint8)
    return DeviceDataset(
        images=torch.from_numpy(images).to(device),
        masks=torch.from_numpy(masks).to(device),
        cameras=cameras,
        train_indices=torch.as_tensor(np.asarray(train_indices), dtype=torch.int64, device=device),
    )


def subsample_train_images(data: DeviceDataset, max_images: int) -> DeviceDataset:
    """Keep at most ``max_images`` of the train images, evenly spaced over
    them (the JAX twin's indices: the big and huge presets train on 200)."""
    idx = data.train_indices.cpu().numpy()
    if len(idx) <= max_images:
        return data
    keep = np.unique(np.linspace(0, len(idx) - 1, max_images, dtype=np.int64))
    return dataclasses.replace(
        data, train_indices=torch.as_tensor(idx[keep], device=data.train_indices.device))


# ---------------------------------------------------------------------------
# optimizer: one parameter group per JAX label, each Adam or RAdam
# ---------------------------------------------------------------------------


def learning_rate(opt: OptimizerConfig, step: int, max_iters: int) -> float:
    """optax's continuous ``exponential_decay`` from lr_init to lr_final over
    ``opt.max_steps`` (``max_iters`` when None); with a warmup, lr is 0
    until ``warmup_steps`` and the decay's count restarts there
    (``join_schedules``)."""
    if step < opt.warmup_steps:
        return 0.0
    count = step - opt.warmup_steps
    steps = opt.max_steps or max_iters
    return opt.lr_init * (opt.lr_final / opt.lr_init) ** (count / steps)


def _group_params(params: dict) -> dict[str, list[torch.Tensor]]:
    """Each group's tensors in the canonical leaf order, so that an
    optimizer state restores onto the same tensors however the parameter
    dicts were built (``init_train_state`` or ``bridge``). A field without
    appearance embeddings (``SemanticNeRFField``) has no appearance group."""
    field = params["model"]["field"]
    groups = {"fields": tree_leaves({k: v for k, v in field.items() if k != "appearance"})}
    if "appearance" in field:
        groups["appearance"] = [field["appearance"]]
    groups["proposal_networks"] = tree_leaves(params["model"]["proposal_networks"])
    groups["camera_opt"] = [params["camera_opt"]]
    return groups


def _group_configs(config: TrainConfig) -> dict[str, OptimizerConfig]:
    return {
        "fields": config.fields_opt,
        "appearance": config.appearance_opt,
        "proposal_networks": config.proposal_opt,
        "camera_opt": config.camera_opt,
    }


class RAdam(torch.optim.Optimizer):
    """RAdam as optax computes it: ``scale_by_radam`` (b1 0.9, b2 0.999,
    threshold 5), then the group's lr and its decoupled decay (wd*lr*p).

    Each step's scalars (the bias corrections, rho_t and the rectifier r_t)
    are float32, computed on the host with numpy in optax's order and staged
    on the device (``StepScalars``). From step
    6, rho_t = rho_inf - 2t b2^t / (1 - b2^t) subtracts about 1993 from 1999,
    so its float32 rounding moves r_t by up to 1e-2 of itself; optax rounds
    there, and ``torch.optim.RAdam`` (Python floats) does not. The
    elementwise work runs as ``torch._foreach_*`` calls over a group.

    One update covers both sides of the threshold (``step_scalars``): past
    it the denominator is sqrt(nu / (1 - b2^t)) + eps; below it the step
    divides nu by inf and adds 1, so the denominator is exactly 1 and the
    update mu_hat, with no extra pass over the moments past it. So a step
    captured at one count serves every count."""

    B1, B2, THRESHOLD = 0.9, 0.999, 5.0
    NUM_SCALARS = 6  # step_scalars' length

    def __init__(self, groups):
        super().__init__(groups, dict(lr=0.0, eps=1e-8, weight_decay=0.0))

    @classmethod
    def scalars(cls, count: int) -> tuple[float, float, float | None]:
        """-> (1 - b1^t, 1 - b2^t, r_t or None below the threshold) for
        step count t, in float32 as optax's ``scale_by_radam``."""
        f32 = np.float32
        t = f32(count)
        b2t = f32(cls.B2) ** t
        ro_inf = 2.0 / (1.0 - cls.B2) - 1.0  # a Python float, as in optax
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
        r = None
        if ro >= f32(cls.THRESHOLD):
            num = (ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
            r = float(np.sqrt(num / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return float(f32(1) - f32(cls.B1) ** t), float(f32(1) - b2t), r

    @classmethod
    def step_scalars(cls, count: int, lr: float, weight_decay: float, eps: float) -> tuple:
        """A group's scalars for step count t: (-lr, weight_decay * lr,
        1 - b1^t, then 1 - b2^t, r_t, eps past the threshold and inf, 1, 1
        below it)."""
        bc1, bc2, r = cls.scalars(count)
        rect = (math.inf, 1.0, 1.0) if r is None else (bc2, r, eps)
        return (-lr, weight_decay * lr, bc1, *rect)

    def advance(self):
        """Count a step taken on device scalars in every group."""
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["step"] += 1

    @torch.no_grad()
    def step(self, scalars):
        """Step every group with a gradient on ``scalars``, one float32
        device tensor of its ``step_scalars`` a group (``StepScalars``);
        the caller counts the step (``advance``)."""
        for group, s in zip(self.param_groups, scalars):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = self.B1, self.B2
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            neg_lr, wd_lr, bc1, bc2, r, floor = s.unbind()
            grads = [p.grad for p in params]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            upd = torch._foreach_div(mu, bc1)  # mu_hat
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            # a device scalar added a tensor at a time: _foreach_add_ of one
            # does not capture
            torch._foreach_add_(den, [floor] * len(den))
            upd = torch._foreach_div(torch._foreach_mul(upd, r), den)
            torch._foreach_mul_(upd, neg_lr)
            if group["weight_decay"]:
                torch._foreach_sub_(upd, torch._foreach_mul(params, wd_lr))
            torch._foreach_add_(params, upd)


class GroupOptimizer:
    """The train state's optimizer when a group takes RAdam:
    ``torch.optim.Adam`` over the Adam groups and ``RAdam`` over the others,
    which ``optimizer_step`` steps. ``state_dict`` holds each one's under its
    name."""

    def __init__(self, parts: dict[str, torch.optim.Optimizer]):
        self.parts = parts

    @property
    def param_groups(self) -> list[dict]:
        return [g for opt in self.parts.values() for g in opt.param_groups]

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.parts.values():
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {name: opt.state_dict() for name, opt in self.parts.items()}

    def load_state_dict(self, state: dict):
        if set(state) != set(self.parts):
            raise ValueError(f"optimizer state of {sorted(state)}; this run steps {sorted(self.parts)}")
        for name, opt in self.parts.items():
            opt.load_state_dict(state[name])


def _parts(optimizer) -> list[torch.optim.Optimizer]:
    return list(optimizer.parts.values()) if isinstance(optimizer, GroupOptimizer) else [optimizer]


def step_count(opt: torch.optim.Optimizer, group: dict) -> int:
    """The steps ``group`` of ``opt`` (Adam or RAdam) has taken."""
    st = opt.state.get(group["params"][0])
    return int(st["step"]) if st else 0


ADAM_SCALARS = 3  # adam_scalars' length


def adam_scalars(count: int, lr: float, weight_decay: float, betas) -> tuple:
    """An Adam group's scalars for step count t, as ``torch.optim.Adam``'s
    foreach step computes them on the host: (1 - lr * weight_decay,
    sqrt(1 - b2^t), -lr / (1 - b1^t))."""
    b1, b2 = betas
    t = float(count)
    return (1 - lr * weight_decay, (1 - b2 ** t) ** 0.5, (lr / (1 - b1 ** t)) * -1)


@torch.no_grad()
def adam_step(opt: torch.optim.Adam, scalars: list) -> None:
    """``opt.step()`` as torch's foreach Adam makes it on the card (decoupled
    decay, no amsgrad), with each group's ``adam_scalars`` read from a
    float32 device tensor (``StepScalars``): the same operations in the same
    order, so a step can be captured. On the CPU it rounds otherwise than
    torch's single-tensor Adam there, by about one ulp a step. The step
    counts are left to ``count_step``."""
    for group, s in zip(opt.param_groups, scalars):
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            continue
        for p in params:
            if not opt.state[p]:
                opt.state[p].update(step=torch.tensor(0.0),
                                    exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                                    exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        b1, b2 = group["betas"]
        decay, bc2_sqrt, neg_step = s.unbind()
        grads = [p.grad for p in params]
        mu = [opt.state[p]["exp_avg"] for p in params]
        nu = [opt.state[p]["exp_avg_sq"] for p in params]
        if group["weight_decay"]:
            torch._foreach_mul_(params, decay)
        torch._foreach_lerp_(mu, grads, 1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_div_(den, bc2_sqrt)
        torch._foreach_add_(den, group["eps"])
        # p + step * (mu / den), addcdiv's arithmetic with a device step size
        torch._foreach_addcmul_(params, [neg_step] * len(params), torch._foreach_div(mu, den))


def group_algorithms(optimizer) -> dict[str, str]:
    """{group name: "adam" or "radam"} of a train state's optimizer."""
    if isinstance(optimizer, GroupOptimizer):
        return {g["name"]: name for name, opt in optimizer.parts.items()
                for g in opt.param_groups}
    return {g["name"]: "adam" for g in optimizer.param_groups}


def make_optimizer(params: dict, config: TrainConfig):
    """One parameter group per JAX label, each stepped by the algorithm its
    config names. Adam has eps outside the sqrt, as optax's; the appearance
    group's decoupled decay subtracts wd*lr*p, as optax's chain and AdamW
    do. With every group on Adam this is one ``torch.optim.Adam``; with a
    RAdam group, a ``GroupOptimizer``. Either holds the groups and their
    state (and so keeps its checkpoint format); ``optimizer_step`` steps
    them. A group's ``lr`` is its rate at step 0 and is not written again:
    a step's rates live in its staged scalars (``StepScalars``)."""
    opts = _group_configs(config)
    groups = {"adam": [], "radam": []}
    for name, ps in _group_params(params).items():
        opt = opts[name]
        if opt.name not in groups:
            raise ValueError(f"unknown optimizer {opt.name!r} for the {name} group")
        group = {"name": name, "params": ps, "lr": learning_rate(opt, 0, config.max_iters),
                 "eps": opt.eps, "weight_decay": opt.weight_decay}
        if opt.name == "adam":
            group["decoupled_weight_decay"] = True
        groups[opt.name].append(group)
    if not groups["radam"]:
        return torch.optim.Adam(groups["adam"])
    parts = {"radam": RAdam(groups["radam"])}
    if groups["adam"]:
        parts["adam"] = torch.optim.Adam(groups["adam"])
    return GroupOptimizer(parts)


@dataclasses.dataclass
class TrainState:
    params: dict  # {"model": {"field": ..., "proposal_networks": [...]}, "camera_opt": [N,6]}
    optimizer: torch.optim.Adam | GroupOptimizer
    step: int = 0
    # the step's staged scalars (stage_scalars) and, on the card, its captured
    # graphs (step_graph.run_step)
    scalars: StepScalars | None = dataclasses.field(default=None, repr=False, compare=False)
    graphs: StepGraphs | None = dataclasses.field(default=None, repr=False, compare=False)


class StepScalars:
    """A train step's scalars in one float32 buffer on the parameters'
    device: the proposal anneal, each Adam group's ``adam_scalars`` and each
    RAdam group's ``RAdam.step_scalars``, computed on the host. ``stage``
    copies them in before a step; on the card from pinned memory, which
    torch's host allocator does not hand out again until the copy has run,
    so the host may run many steps ahead of the card. A step reads them on
    the device, so a captured step serves every step of its proposal gate.
    Once the anneal is 1 the step takes the host's 1 (``annealing``), whose
    power is a copy."""

    def __init__(self, optimizer, device):
        self.optimizer = optimizer
        sizes = [RAdam.NUM_SCALARS if isinstance(opt, RAdam) else ADAM_SCALARS
                 for opt in _parts(optimizer) for _ in opt.param_groups]
        self.buffer = torch.zeros(1 + sum(sizes), dtype=torch.float32, device=device)
        self.anneal = self.buffer[0]
        self.annealing = True
        views = list(torch.split(self.buffer[1:], sizes))
        # one view a group, in each part's order
        self.radam, self.adam = [], []
        for opt in _parts(optimizer):
            mine = [views.pop(0) for _ in opt.param_groups]
            (self.radam if isinstance(opt, RAdam) else self.adam).extend(mine)

    def values(self, step: int, config: TrainConfig) -> np.ndarray:
        """The scalars of a step at ``state.step == step``."""
        out = [proposal_anneal(step, config.model)]
        opts = _group_configs(config)
        for opt in _parts(self.optimizer):
            for group in opt.param_groups:
                lr = learning_rate(opts[group["name"]], step, config.max_iters)
                count = step_count(opt, group) + 1
                if isinstance(opt, RAdam):
                    out += RAdam.step_scalars(count, lr, group["weight_decay"], group["eps"])
                else:
                    out += adam_scalars(count, lr, group["weight_decay"], group["betas"])
        return np.asarray(out, dtype=np.float32)

    def stage(self, step: int, config: TrainConfig):
        values = self.values(step, config)
        self.annealing = bool(values[0] != 1.0)
        host = torch.from_numpy(values)
        self.buffer.copy_(host.pin_memory() if self.buffer.is_cuda else host, non_blocking=True)


def stage_scalars(state: TrainState, config: TrainConfig) -> None:
    """Stage the scalars of the state's next step (``state.scalars``, made
    anew for another optimizer) on the parameters' device."""
    if getattr(state.scalars, "optimizer", None) is not state.optimizer:
        state.scalars = StepScalars(state.optimizer,
                                    state.optimizer.param_groups[0]["params"][0].device)
    state.scalars.stage(state.step, config)


def init_train_state(
    config: TrainConfig,
    num_cameras: int,
    device,
    generator: torch.Generator | None = None,
    params: dict | None = None,
) -> TrainState:
    """Fresh parameters from ``generator`` (seeded with ``config.seed`` when
    None), or the given ``params`` (for example from ``bridge``)."""
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(config.seed)
        params = {
            "model": init_fruit_model(config.model, generator, device),
            "camera_opt": init_camera_opt(num_cameras, device),
        }
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return TrainState(params=params, optimizer=make_optimizer(params, config))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepDraws:
    """Every random number one train step uses."""

    slot: torch.Tensor  # [R] int64 index into train_indices
    py: torch.Tensor  # [R] int64 pixel row
    px: torch.Tensor  # [R] int64 pixel column
    jitter: torch.Tensor  # [2, R] sub-pixel offsets in [-0.5, 0.5)
    # uniforms in [0,1), one tensor a sampler stage ([R, 1] with the single
    # jitter, else one a bin: fruit_model.sampler_draw_shapes)
    sampler: list[torch.Tensor]
    sparse_points: torch.Tensor  # [Nsp, 3] world points of the sparsity prior


def draw_step(config: TrainConfig, data: DeviceDataset, generator: torch.Generator) -> StepDraws:
    """Draw a step's random numbers on the data's device."""
    dev = data.images.device
    r = config.train_rays_per_batch
    h, w = data.image_shape
    mc = config.model

    def randint(high):
        return torch.randint(0, high, (r,), generator=generator, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    slot = randint(data.train_indices.shape[0])
    py, px = randint(h), randint(w)
    jitter = rand(2, r) - 0.5
    sampler = [rand(*shape) for shape in sampler_draw_shapes(mc, r)]
    ext = mc.sparsity_extent
    sparse = rand(mc.sparsity_num_points, 3) * (2.0 * ext) - ext
    return StepDraws(slot, py, px, jitter, sampler, sparse)


def _sparsity_loss(params: dict, data: DeviceDataset, config: TrainConfig, pts) -> torch.Tensor:
    mc = config.model
    dens = field_density(params["model"]["field"], pts, mc.field)
    occ = 1.0 - torch.exp(-dens * mc.sparsity_cell)
    if mc.sparsity_unobserved_boost > 1.0:
        # boost the prior where no training frustum sees the point
        cov = frustum_coverage(data.cameras, pts, camera_indices=data.train_indices)
        occ = occ * torch.where(cov > 0, 1.0, mc.sparsity_unobserved_boost)
    return mc.density_sparsity_mult * torch.mean(occ)


def compute_loss(state: TrainState, data: DeviceDataset, config: TrainConfig, draws: StepDraws):
    """-> (total loss, {loss name: tensor}, metrics) for one step's draws, at
    the proposal anneal staged in ``state.scalars``: the device scalar while
    the anneal runs (on the data's device, which a multi-scene step's scene
    group may have other than the scalars'), else the host's."""
    params = state.params
    mc = config.model
    scalars = state.scalars
    anneal = scalars.anneal.to(data.images.device) if scalars.annealing else None
    with span("rays"):
        cam = data.train_indices[draws.slot]
        rgb_gt = data.images[cam, draws.py, draws.px].float() / 255.0
        mask_gt = data.masks[cam, draws.py, draws.px].float()
        if config.train_subpixel_jitter:
            ray_y = draws.py.float() + draws.jitter[0]
            ray_x = draws.px.float() + draws.jitter[1]
        else:
            ray_y, ray_x = draws.py, draws.px
        adj = exp_map_so3xr3(params["camera_opt"]) if config.use_camera_opt else None
        bundle = near_far_collider(
            generate_rays(data.cameras, cam, ray_y, ray_x, pose_adjustment=adj),
            mc.near_plane, mc.far_plane)
    outputs = forward_collided(params["model"], bundle, mc, draws.sampler, state.step, train=True,
                               anneal=anneal)
    sparsity = None
    if mc.density_sparsity_mult > 0:
        with span("sparsity"):
            sparsity = _sparsity_loss(params, data, config, draws.sparse_points)
    with span("losses"):
        losses = loss_dict(outputs, rgb_gt, mask_gt, mc)
        if sparsity is not None:
            losses["sparsity_loss"] = sparsity
        total = sum(losses.values())
        return total, losses, metrics_dict(outputs, rgb_gt)


def optimizer_step(state: TrainState, config: TrainConfig, count: bool = True) -> None:
    """Step ``state.optimizer`` on the gradients in the parameters' ``.grad``
    at the rates and step scalars staged in ``state.scalars`` from
    ``config`` (``stage_scalars``): ``adam_step`` for the Adam groups,
    ``RAdam.step`` for the RAdam ones; then count the step. ``count=False``
    leaves the counting to the caller (a captured step is counted at each
    replay: ``count_step``)."""
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:  # gated proposal nets: the optimizer still steps on zeros
                p.grad = torch.zeros_like(p)
    for opt in _parts(state.optimizer):
        if isinstance(opt, RAdam):
            opt.step(state.scalars.radam)
        else:
            adam_step(opt, state.scalars.adam)
    if count:
        count_step(state)


def count_step(state: TrainState) -> None:
    """Count a step: the state's step and the optimizers' step counts."""
    state.step += 1
    for opt in _parts(state.optimizer):
        if isinstance(opt, RAdam):
            opt.advance()
        else:
            for st in opt.state.values():
                st["step"] += 1


def step_metrics(metrics: dict, losses: dict, total: torch.Tensor) -> dict:
    """A step's metrics with its losses and total, detached."""
    out = {**metrics, **{k: v.detach() for k, v in losses.items()}}
    out["total_loss"] = total.detach()
    return out


def camera_opt_metrics(camera_opt: torch.Tensor, dims=None) -> dict:
    """Norms of the camera-opt translations and rotations (over ``dims``,
    every axis when None)."""
    t = camera_opt.detach()
    return {"camera_opt_translation": torch.linalg.vector_norm(t[..., 3:], dim=dims),
            "camera_opt_rotation": torch.linalg.vector_norm(t[..., :3], dim=dims)}


def _mesh_metrics(metrics: dict, mesh) -> dict:
    """The metrics averaged over the ranks, the PSNR formed from the
    averaged RGB loss (an average of the ranks' PSNRs is not the batch's)."""
    from ..parallel.mesh import average

    names = [k for k in metrics if k != "psnr"]
    out = dict(zip(names, average([metrics[k] for k in names], mesh)))
    out["psnr"] = -10.0 * torch.log10(torch.clamp_min(out["rgb_loss"], 1e-10))
    return out


def train_step(
    state: TrainState,
    data: DeviceDataset,
    config: TrainConfig,
    generator: torch.Generator | None = None,
    draws: StepDraws | None = None,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """One step: draws (from ``generator`` unless given), loss, backward,
    the optimizer. Updates ``state`` in place and returns the step's metrics as
    device scalars (reading them synchronises).

    With ``mesh`` (``parallel/mesh.py:DataMesh``) the draws are the global
    step's, every rank's alike; this rank keeps its shard of them, and the
    gradients and metrics are averaged over the ranks (the twin is
    ``make_train_step(config, mesh)``).

    The step reads its scalars from the parameters' device (``StepScalars``,
    staged first). On the card a step that draws from ``generator``,
    without ``mesh``, replays the step captured for its proposal gate
    (``step_graph.run_step``), the same work on the same tensors."""
    from .step_graph import run_step

    return run_step(state, data, config, [generator],
                    lambda count: _step(state, data, config, generator, draws, mesh, count),
                    eager=draws is not None or mesh is not None)


def _step(state, data, config, generator, draws, mesh, count=True) -> dict:
    """``train_step``'s work on its staged scalars; ``count``: as in
    ``optimizer_step``."""
    if draws is None:
        with span("draws"):
            draws = draw_step(config, data, generator)
    if mesh is not None:
        from ..parallel.mesh import average_gradients, shard_draws

        draws = shard_draws(draws, mesh)
    total, losses, metrics = compute_loss(state, data, config, draws)
    with span("backward"):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    if mesh is not None:
        average_gradients(state.params, mesh)
    with span("optimizer"):
        if count:  # an eager step's call keeps its signature: the benchmark's fault tests patch it
            optimizer_step(state, config)
        else:
            optimizer_step(state, config, count=False)
    with span("metrics"):
        metrics = step_metrics(metrics, losses, total)
        if mesh is not None:
            metrics = _mesh_metrics(metrics, mesh)
        if config.use_camera_opt:
            metrics.update(camera_opt_metrics(state.params["camera_opt"]))
        return metrics


def graph_reads(state: TrainState, data: DeviceDataset, config: TrainConfig, generators) -> tuple:
    """What a captured step reads and writes, by identity: the config, each
    generator, the staged scalars, the data's tensors (a multi-scene step's
    stacked ones), the parameters and the optimizer's state tensors."""
    cams = data.cameras
    return (config, *generators, state.scalars.buffer, data.images, data.masks,
            data.train_indices, *(getattr(cams, f.name) for f in dataclasses.fields(cams)),
            *tree_leaves(state.params),
            *(t for opt in _parts(state.optimizer) for st in opt.state.values()
              for t in st.values() if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# chunked eval render
# ---------------------------------------------------------------------------

_PANELS = ("rgb", "depth", "accumulation", "semantics", "semantics_colormap")


@torch.no_grad()
def render_camera(
    params: dict, cameras: Cameras, camera_index: int, config: TrainConfig,
    devices=None,
) -> dict[str, torch.Tensor]:
    """Render every output panel of one camera ([H,W,...] tensors, on the
    parameters' device) in chunks of ``eval_rays_per_chunk`` rays, eval
    mode.

    ``devices`` (a list; default the parameters' device): the image's rays
    are split into contiguous shards, one a device; each device renders its
    shard in chunks with its own copy of the parameters, and the shards are
    gathered in order (the twin's ``_render_sharded_fn``: the ray axis
    sharded over the mesh)."""
    h = int(cameras.height[camera_index])
    w = int(cameras.width[camera_index])
    bundle = generate_image_rays(cameras, camera_index, h, w)
    home = bundle.origins.device
    devices = devices or [home]
    shard = -(-(h * w) // len(devices))
    parts = {k: [] for k in _PANELS}
    for i, dev in enumerate(devices):  # launches on distinct cards overlap
        rays = bundle[i * shard : (i + 1) * shard].to(dev)
        model = tree_map(params["model"], lambda t, d=dev: t.to(d))  # a copy a device
        for start in range(0, rays.origins.shape[0], config.eval_rays_per_chunk):
            out = forward_train(
                model, rays[start : start + config.eval_rays_per_chunk], config.model,
                uniforms=None, step=1 << 30, train=False,
            )
            for k in _PANELS:
                parts[k].append(out[k])
    return {
        k: torch.cat([t.to(home) for t in v]).reshape(h, w, *v[0].shape[1:])
        for k, v in parts.items()
    }


# ---------------------------------------------------------------------------
# eval metrics and the outer loop
# ---------------------------------------------------------------------------


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_image(
    params: dict, data: DeviceDataset, camera_index: int, config: TrainConfig,
    lpips_weights_path=None, devices=None,
) -> tuple[dict, dict]:
    """Render one eval camera -> ({psnr, ssim, iou, iou_reference_quirk,
    num_rays_per_sec, fps} as floats, the rendered panels). LPIPS is
    reported too when backbone weights are given (``utils/lpips.py``).
    ``devices``: as in ``render_camera``."""
    dev = data.images.device
    for d in {dev, *map(torch.device, devices or ())}:
        _sync(d)
    t0 = time.perf_counter()
    out = render_camera(params, data.cameras, camera_index, config, devices)
    _sync(dev)
    dt = time.perf_counter() - t0
    h, w = out["rgb"].shape[:2]
    gt = data.images[camera_index].float() / 255.0
    mask = data.masks[camera_index].float()
    logits = out["semantics"][..., 0]
    m = torch.stack([
        M.psnr(out["rgb"], gt), M.ssim(out["rgb"], gt), M.binary_iou(logits, mask),
        M.binary_iou_reference_quirk(logits, mask),
    ]).tolist()  # one device-to-host copy
    stats = dict(zip(("psnr", "ssim", "iou", "iou_reference_quirk"), m))
    stats.update(num_rays_per_sec=h * w / dt, fps=1.0 / dt)
    if lpips_weights_path is not None:
        from ..utils.lpips import lpips

        stats["lpips"] = lpips(out["rgb"], gt, weights_path=lpips_weights_path)
    return stats, out


def evaluate_all(params: dict, data: DeviceDataset, indices, config: TrainConfig,
                 lpips_weights_path=None, devices=None) -> dict:
    """Eval metrics and throughput averaged over the cameras ``indices``;
    ``devices``: as in ``render_camera``."""
    all_stats = [evaluate_image(params, data, int(ci), config, lpips_weights_path, devices)[0]
                 for ci in indices]
    return {k: float(np.mean([s[k] for s in all_stats])) for k in all_stats[0]}


def train_loop(
    config: TrainConfig,
    data: DeviceDataset,
    eval_indices=None,
    state: TrainState | None = None,
    generator: torch.Generator | None = None,
    writer=None,
    checkpoint_dir=None,
    callbacks=(),
    timings: dict | None = None,
    mesh=None,
) -> TrainState:
    """Train from ``state.step`` (a fresh state when None) to
    ``config.max_iters``, one ``train_step`` at a time.

    * Every ``steps_per_log`` steps the step's metrics go to ``writer``
      (``fruitnerf_tpu_torch.utils.writer.MetricWriter``).
    * Every ``steps_per_eval`` steps one camera of ``eval_indices`` is
      evaluated, rotating through them; its stats go to ``writer`` as
      ``eval_*``.
    * Every ``steps_per_save`` steps, and at the end, the state and the
      generator's state are checkpointed to ``checkpoint_dir``: copied to
      host memory at once, written by a worker thread while training goes
      on (``checkpoints.save_checkpoint_async``); every write has ended
      when the loop returns.
    * With a ``checkpoint_dir``, SIGTERM and SIGINT (handled on the main
      thread only) checkpoint after the current step and return early;
      ``checkpoints.resume_from_latest`` picks the run up.
    * Each ``callbacks`` entry is called as ``cb(step, state, metrics)``
      after every step.

    All draws come from ``generator`` (seeded with ``config.seed`` when
    None), which also initialises a fresh state. ``timings`` (optional) is
    filled with the wall seconds of each section: train_s, eval_s, save_s.

    With ``mesh`` (``parallel/mesh.py:DataMesh``, the twin's
    ``train_loop(mesh=)``) every rank runs this loop on its own device with
    an identically seeded generator: the initial parameters must be equal
    on every rank (checked), each step trains on the rank's shard of the
    global draws with the gradients averaged, and only rank 0 evaluates,
    writes to ``writer`` and checkpoints. No signal handler is installed
    then: a rank that stopped alone would leave the others waiting in the
    next average, so a preempted data-parallel run resumes from its last
    periodic checkpoint.
    """
    dev = data.images.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    if state is None:
        state = init_train_state(config, data.cameras.num_cameras, dev, generator=generator)
    if mesh is not None:
        from ..parallel.mesh import check_batch, check_replicated

        check_batch(config, mesh)
        check_replicated(state.params, mesh)
        if not mesh.lead:
            writer = checkpoint_dir = eval_indices = None
    if timings is None:
        timings = {}
    for k in ("train_s", "eval_s", "save_s"):
        timings.setdefault(k, 0.0)

    def every(n: int, it: int) -> bool:
        return n > 0 and it % n == 0

    stop = threading.Event()
    prev_handlers = {}
    if checkpoint_dir is not None and mesh is None \
            and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, lambda signum, frame: stop.set())
    do_eval = eval_indices is not None and len(eval_indices) > 0
    saver = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
    pending: list[concurrent.futures.Future] = []

    def flush():
        for fut in pending:
            fut.result()  # surfaces a failed write
        pending.clear()

    try:
        it = state.step
        t_train = time.perf_counter()
        while it < config.max_iters:
            metrics = train_step(state, data, config, generator, mesh=mesh)
            it = state.step
            if writer is not None and every(config.steps_per_log, it):
                with span("log"):
                    names = list(metrics)
                    values = torch.stack([metrics[k].float() for k in names]).tolist()
                    writer.write(it, dict(zip(names, values)))
            eval_now = do_eval and every(config.steps_per_eval, it)
            save_now = checkpoint_dir is not None and every(config.steps_per_save, it)
            if stop.is_set() or eval_now or save_now:
                _sync(dev)  # the queued steps count as training time
                timings["train_s"] += time.perf_counter() - t_train
                if stop.is_set():
                    flush()
                    path = save_checkpoint(checkpoint_dir, state, generator)
                    print(f"train_loop: signal received; checkpointed step {it} to "
                          f"{path}; exiting early", flush=True)
                    return state
                t0 = time.perf_counter()
                if eval_now:
                    which = (it // config.steps_per_eval - 1) % len(eval_indices)
                    with span("eval"):
                        stats, _ = evaluate_image(
                            state.params, data, int(eval_indices[which]), config
                        )
                    if writer is not None:
                        writer.write(it, {f"eval_{k}": v for k, v in stats.items()})
                t1 = time.perf_counter()
                timings["eval_s"] += t1 - t0
                if save_now:
                    with span("save"):
                        pending.append(
                            save_checkpoint_async(checkpoint_dir, state, generator, saver))
                timings["save_s"] += time.perf_counter() - t1
                t_train = time.perf_counter()
            for cb in callbacks:
                cb(it, state, metrics)
        _sync(dev)
        timings["train_s"] += time.perf_counter() - t_train
        t0 = time.perf_counter()
        if checkpoint_dir is not None and config.steps_per_save > 0 \
                and not every(config.steps_per_save, it):
            with span("save"):
                pending.append(save_checkpoint_async(checkpoint_dir, state, generator, saver))
        flush()
        timings["save_s"] += time.perf_counter() - t0
        return state
    finally:
        saver.shutdown(wait=True)
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
