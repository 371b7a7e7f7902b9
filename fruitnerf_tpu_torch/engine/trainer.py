"""Training engine: device-resident data, the train step, per-group Adam,
the chunked eval render, eval metrics and the outer ``train_loop``. Twin of
``fruitnerf_tpu/engine/trainer.py``.

Every random draw of a step is made in one place, ``draw_step``, from an
explicit ``torch.Generator``; ``train_step`` takes the draws, so a test can
inject the JAX step's draws instead.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time

import numpy as np
import torch

from ..bridge import tree_leaves
from ..cameras.camera_opt import exp_map_so3xr3, init_camera_opt
from ..cameras.cameras import Cameras, frustum_coverage, generate_image_rays, generate_rays
from ..configs import OptimizerConfig, TrainConfig
from ..fields.fruit_field import get_density
from ..models.fruit_model import forward_train, init_fruit_model, loss_dict, metrics_dict
from ..utils import metrics as M
from .checkpoints import save_checkpoint


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


# ---------------------------------------------------------------------------
# optimizer: one Adam, one parameter group per JAX label
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
    dicts were built (``init_train_state`` or ``bridge``)."""
    field = params["model"]["field"]
    return {
        "fields": tree_leaves({k: v for k, v in field.items() if k != "appearance"}),
        "appearance": [field["appearance"]],
        "proposal_networks": tree_leaves(params["model"]["proposal_networks"]),
        "camera_opt": [params["camera_opt"]],
    }


def _group_configs(config: TrainConfig) -> dict[str, OptimizerConfig]:
    return {
        "fields": config.fields_opt,
        "appearance": config.appearance_opt,
        "proposal_networks": config.proposal_opt,
        "camera_opt": config.camera_opt,
    }


def make_optimizer(params: dict, config: TrainConfig) -> torch.optim.Adam:
    """Adam with eps outside the sqrt, as optax's; the appearance group's
    decoupled decay subtracts wd*lr*p, as optax's chain and AdamW do."""
    opts = _group_configs(config)
    groups = [
        {
            "name": name,
            "params": ps,
            "lr": learning_rate(opts[name], 0, config.max_iters),
            "eps": opts[name].eps,
            "weight_decay": opts[name].weight_decay,
            "decoupled_weight_decay": True,
        }
        for name, ps in _group_params(params).items()
    ]
    return torch.optim.Adam(groups)


@dataclasses.dataclass
class TrainState:
    params: dict  # {"model": {"field": ..., "proposal_networks": [...]}, "camera_opt": [N,6]}
    optimizer: torch.optim.Adam
    step: int = 0


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
    sampler: list[torch.Tensor]  # [R, 1] uniforms in [0,1), one per sampler stage
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
    sampler = [rand(r, 1) for _ in range(len(mc.proposal_nets) + 1)]
    ext = mc.sparsity_extent
    sparse = rand(mc.sparsity_num_points, 3) * (2.0 * ext) - ext
    return StepDraws(slot, py, px, jitter, sampler, sparse)


def _sparsity_loss(params: dict, data: DeviceDataset, config: TrainConfig, pts) -> torch.Tensor:
    mc = config.model
    dens, _ = get_density(params["model"]["field"], pts, mc.field)
    occ = 1.0 - torch.exp(-dens * mc.sparsity_cell)
    if mc.sparsity_unobserved_boost > 1.0:
        # boost the prior where no training frustum sees the point
        cov = frustum_coverage(data.cameras, pts, camera_indices=data.train_indices)
        occ = occ * torch.where(cov > 0, 1.0, mc.sparsity_unobserved_boost)
    return mc.density_sparsity_mult * torch.mean(occ)


def compute_loss(state: TrainState, data: DeviceDataset, config: TrainConfig, draws: StepDraws):
    """-> (total loss, {loss name: tensor}, metrics) for one step's draws."""
    params = state.params
    cam = data.train_indices[draws.slot]
    rgb_gt = data.images[cam, draws.py, draws.px].float() / 255.0
    mask_gt = data.masks[cam, draws.py, draws.px].float()
    if config.train_subpixel_jitter:
        ray_y = draws.py.float() + draws.jitter[0]
        ray_x = draws.px.float() + draws.jitter[1]
    else:
        ray_y, ray_x = draws.py, draws.px
    adj = exp_map_so3xr3(params["camera_opt"]) if config.use_camera_opt else None
    bundle = generate_rays(data.cameras, cam, ray_y, ray_x, pose_adjustment=adj)
    outputs = forward_train(
        params["model"], bundle, config.model, draws.sampler, state.step, train=True
    )
    losses = loss_dict(outputs, rgb_gt, mask_gt, config.model)
    if config.model.density_sparsity_mult > 0:
        losses["sparsity_loss"] = _sparsity_loss(params, data, config, draws.sparse_points)
    total = sum(losses.values())
    return total, losses, metrics_dict(outputs, rgb_gt)


def train_step(
    state: TrainState,
    data: DeviceDataset,
    config: TrainConfig,
    generator: torch.Generator | None = None,
    draws: StepDraws | None = None,
) -> dict[str, torch.Tensor]:
    """One step: draws (from ``generator`` unless given), loss, backward,
    Adam. Updates ``state`` in place and returns the step's metrics as
    device scalars (reading them synchronises)."""
    if draws is None:
        draws = draw_step(config, data, generator)
    total, losses, metrics = compute_loss(state, data, config, draws)
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    total.backward()
    opts = _group_configs(config)
    for group in opt.param_groups:
        group["lr"] = learning_rate(opts[group["name"]], state.step, config.max_iters)
        for p in group["params"]:
            if p.grad is None:  # gated proposal nets: Adam still steps on zeros
                p.grad = torch.zeros_like(p)
    opt.step()
    state.step += 1
    metrics = {**metrics, **{k: v.detach() for k, v in losses.items()}}
    metrics["total_loss"] = total.detach()
    if config.use_camera_opt:
        t = state.params["camera_opt"].detach()
        metrics["camera_opt_translation"] = torch.linalg.vector_norm(t[..., 3:])
        metrics["camera_opt_rotation"] = torch.linalg.vector_norm(t[..., :3])
    return metrics


# ---------------------------------------------------------------------------
# chunked eval render
# ---------------------------------------------------------------------------

_PANELS = ("rgb", "depth", "accumulation", "semantics", "semantics_colormap")


@torch.no_grad()
def render_camera(
    params: dict, cameras: Cameras, camera_index: int, config: TrainConfig
) -> dict[str, torch.Tensor]:
    """Render every output panel of one camera ([H,W,...] tensors) in
    chunks of ``eval_rays_per_chunk`` rays, eval mode."""
    h = int(cameras.height[camera_index])
    w = int(cameras.width[camera_index])
    bundle = generate_image_rays(cameras, camera_index, h, w)
    chunk = config.eval_rays_per_chunk
    parts = {k: [] for k in _PANELS}
    for start in range(0, h * w, chunk):
        out = forward_train(
            params["model"], bundle[start : start + chunk], config.model,
            uniforms=None, step=1 << 30, train=False,
        )
        for k in _PANELS:
            parts[k].append(out[k])
    return {k: torch.cat(v).reshape(h, w, *v[0].shape[1:]) for k, v in parts.items()}


# ---------------------------------------------------------------------------
# eval metrics and the outer loop
# ---------------------------------------------------------------------------


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_image(
    params: dict, data: DeviceDataset, camera_index: int, config: TrainConfig
) -> tuple[dict, dict]:
    """Render one eval camera -> ({psnr, ssim, iou, iou_reference_quirk,
    num_rays_per_sec, fps} as floats, the rendered panels)."""
    dev = data.images.device
    _sync(dev)
    t0 = time.perf_counter()
    out = render_camera(params, data.cameras, camera_index, config)
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
    return stats, out


def evaluate_all(params: dict, data: DeviceDataset, indices, config: TrainConfig) -> dict:
    """Eval metrics and throughput averaged over the cameras ``indices``."""
    all_stats = [evaluate_image(params, data, int(ci), config)[0] for ci in indices]
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
) -> TrainState:
    """Train from ``state.step`` (a fresh state when None) to
    ``config.max_iters``, one ``train_step`` at a time.

    * Every ``steps_per_log`` steps the step's metrics go to ``writer``
      (``fruitnerf_tpu.utils.writer.MetricWriter``).
    * Every ``steps_per_eval`` steps one camera of ``eval_indices`` is
      evaluated, rotating through them; its stats go to ``writer`` as
      ``eval_*``.
    * Every ``steps_per_save`` steps, and at the end, the state and the
      generator's state are checkpointed to ``checkpoint_dir``.
    * With a ``checkpoint_dir``, SIGTERM and SIGINT (handled on the main
      thread only) checkpoint after the current step and return early;
      ``checkpoints.resume_from_latest`` picks the run up.
    * Each ``callbacks`` entry is called as ``cb(step, state, metrics)``
      after every step.

    All draws come from ``generator`` (seeded with ``config.seed`` when
    None), which also initialises a fresh state. ``timings`` (optional) is
    filled with the wall seconds of each section: train_s, eval_s, save_s.
    """
    dev = data.images.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    if state is None:
        state = init_train_state(config, data.cameras.num_cameras, dev, generator=generator)
    if timings is None:
        timings = {}
    for k in ("train_s", "eval_s", "save_s"):
        timings.setdefault(k, 0.0)

    def every(n: int, it: int) -> bool:
        return n > 0 and it % n == 0

    stop = threading.Event()
    prev_handlers = {}
    if checkpoint_dir is not None and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, lambda signum, frame: stop.set())
    do_eval = eval_indices is not None and len(eval_indices) > 0
    try:
        it = state.step
        t_train = time.perf_counter()
        while it < config.max_iters:
            metrics = train_step(state, data, config, generator)
            it = state.step
            if writer is not None and every(config.steps_per_log, it):
                names = list(metrics)
                values = torch.stack([metrics[k].float() for k in names]).tolist()
                writer.write(it, dict(zip(names, values)))
            eval_now = do_eval and every(config.steps_per_eval, it)
            save_now = checkpoint_dir is not None and every(config.steps_per_save, it)
            if stop.is_set() or eval_now or save_now:
                _sync(dev)  # the queued steps count as training time
                timings["train_s"] += time.perf_counter() - t_train
                if stop.is_set():
                    path = save_checkpoint(checkpoint_dir, state, generator)
                    print(f"train_loop: signal received; checkpointed step {it} to "
                          f"{path}; exiting early", flush=True)
                    return state
                t0 = time.perf_counter()
                if eval_now:
                    which = (it // config.steps_per_eval - 1) % len(eval_indices)
                    stats, _ = evaluate_image(
                        state.params, data, int(eval_indices[which]), config
                    )
                    if writer is not None:
                        writer.write(it, {f"eval_{k}": v for k, v in stats.items()})
                t1 = time.perf_counter()
                timings["eval_s"] += t1 - t0
                if save_now:
                    save_checkpoint(checkpoint_dir, state, generator)
                timings["save_s"] += time.perf_counter() - t1
                t_train = time.perf_counter()
            for cb in callbacks:
                cb(it, state, metrics)
        _sync(dev)
        timings["train_s"] += time.perf_counter() - t_train
        if checkpoint_dir is not None and config.steps_per_save > 0 \
                and not every(config.steps_per_save, it):
            t0 = time.perf_counter()
            save_checkpoint(checkpoint_dir, state, generator)
            timings["save_s"] += time.perf_counter() - t0
        return state
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
