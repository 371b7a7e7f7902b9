"""FruitModel: nerfacto-style semantic NeRF, its train/eval forward, its
inference forward and its export forward. Twin of
``fruitnerf_tpu/models/fruit_model.py``.

Proposal annealing and the proposal-update cadence are functions of the
step, which the trainer keeps on the host. ``proposal_initial_sampler=
"uniform"`` spaces every sampler stage uniformly, as the JAX twin does (the
reference leaves the sampler unset in that branch).

The main field is a ``FruitField`` or, in the ``semantic_nerf`` preset, a
``SemanticNeRFField`` (``fields/semantic_nerf_field.py``); the model picks
its functions by the type of ``FruitModelConfig.field``, as it does the
proposal nets'.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import losses as L
from ..core.rays import RayBundle, near_far_collider
from ..core.render import (
    render_accumulation,
    render_depth_median,
    render_rgb,
    render_semantics,
    semantic_colormap,
)
from ..core.samplers import proposal_sample, spaced_samples
from ..fields.density_field import (
    DensityFieldConfig,
    density_field_forward,
    init_density_field,
)
from ..fields.encodings import HashEncodingConfig
from ..fields.freq_density_field import (
    FreqDensityFieldConfig,
    freq_density_field_forward,
    init_freq_density_field,
)
from ..fields import fruit_field, semantic_nerf_field
from ..fields.fruit_field import FruitFieldConfig, fruit_field_forward, init_fruit_field
from ..fields.semantic_nerf_field import (
    SemanticNerfFieldConfig,
    init_semantic_nerf_field,
    semantic_nerf_forward,
)
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FruitModelConfig:
    field: FruitFieldConfig | SemanticNerfFieldConfig
    # hash-grid DensityFields (the reference's two HashMLPDensityFields), or
    # the grid variant's frequency-MLP fields (configs.TPU_PROPOSAL_NETS)
    proposal_nets: tuple = (
        DensityFieldConfig(
            hash=HashEncodingConfig(num_levels=5, log2_hashmap_size=17, base_res=16, max_res=128)
        ),
        DensityFieldConfig(
            hash=HashEncodingConfig(num_levels=5, log2_hashmap_size=17, base_res=16, max_res=256)
        ),
    )
    num_nerf_samples: int = 48
    num_proposal_samples: tuple = (256, 96)
    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    proposal_initial_sampler: str = "piecewise"  # or "uniform"
    # one sampler jitter a ray (True) or one a bin (False)
    use_single_jitter: bool = True
    semantic_loss_weight: float = 1.0
    interlevel_loss_mult: float = 1.0
    # distortion is a metric; it joins the loss only when switched on
    distortion_loss_mult: float = 0.002
    use_distortion_loss: bool = False
    # occupancy-sparsity prior mean(1 - exp(-sigma * cell)) over uniform
    # world-box points; 0 = off
    density_sparsity_mult: float = 0.0
    sparsity_num_points: int = 4096
    sparsity_extent: float = 2.0
    sparsity_cell: float = 0.01
    # prior multiplier at points outside every training frustum; 1 = off
    sparsity_unobserved_boost: float = 8.0
    use_proposal_weight_anneal: bool = True  # False: the anneal exponent is 1
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    colormap_threshold: float = 0.9


def _init_proposal(config, generator: torch.Generator, device) -> dict:
    if isinstance(config, FreqDensityFieldConfig):
        return init_freq_density_field(config, generator, device)
    return init_density_field(config, generator, device)


def _proposal_forward(params: dict, positions: torch.Tensor, config) -> torch.Tensor:
    if isinstance(config, FreqDensityFieldConfig):
        return freq_density_field_forward(params, positions, config)
    return density_field_forward(params, positions, config)


def field_forward(
    params: dict,
    positions: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: torch.Tensor,
    config,
    train: bool,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The main field's pass (``fruit_field_forward`` or
    ``semantic_nerf_forward``, whose field has no appearance embedding)."""
    if isinstance(config, SemanticNerfFieldConfig):
        return semantic_nerf_forward(params, positions, directions, config, contraction, aabb)
    return fruit_field_forward(params, positions, directions, camera_indices, config, train,
                               contraction, aabb)


def field_density(params: dict, positions: torch.Tensor, config) -> torch.Tensor:
    """World positions [..., 3] -> the main field's density [...]."""
    if isinstance(config, SemanticNerfFieldConfig):
        return semantic_nerf_field.get_density(params, positions, config)
    return fruit_field.get_density(params, positions, config)[0]


def init_fruit_model(
    config: FruitModelConfig, generator: torch.Generator, device
) -> dict:
    init_field = (init_semantic_nerf_field if isinstance(config.field, SemanticNerfFieldConfig)
                  else init_fruit_field)
    return {
        "field": init_field(config.field, generator, device),
        "proposal_networks": [
            _init_proposal(c, generator, device) for c in config.proposal_nets
        ],
    }


def proposal_anneal(step: int, config: FruitModelConfig) -> float:
    """w**anneal exponent: bias(x, b) = b*x / ((b-1)*x + 1) on the fraction
    of the anneal window, in float32 as the JAX twin computes it; 1 with
    the anneal switched off."""
    if not config.use_proposal_weight_anneal:
        return 1.0
    n = config.proposal_weights_anneal_max_num_iters
    x = np.clip(np.float32(step) / np.float32(n), 0.0, 1.0).astype(np.float32)
    b = np.float32(config.proposal_weights_anneal_slope)
    return float(b * x / ((b - np.float32(1.0)) * x + np.float32(1.0)))


def proposal_updated(step: int, config: FruitModelConfig) -> bool:
    """Whether the proposal nets receive gradients this step: every m-th
    step, m ramping from 1 to ``proposal_update_every`` over the warmup."""
    m = np.float32(step) / np.float32(config.proposal_warmup) * np.float32(
        config.proposal_update_every
    )
    m = min(max(m, np.float32(1.0)), np.float32(config.proposal_update_every))
    m_int = max(int(np.round(m)), 1)
    return step < 10 or step % m_int == 0


def sampler_draw_shapes(config: FruitModelConfig, num_rays: int) -> list[tuple[int, int]]:
    """The shape of each sampler stage's uniforms (``forward_train``'s
    ``uniforms``): [R, 1] with the single jitter; else one a bin, [R, n+1]
    for the initial spaced sampler and [R, N+1] for each PDF resampling."""
    if config.use_single_jitter:
        return [(num_rays, 1)] * (len(config.proposal_nets) + 1)
    counts = (*config.num_proposal_samples[1:], config.num_nerf_samples)
    return [(num_rays, config.num_proposal_samples[0] + 1)] + [(num_rays, n + 1) for n in counts]


def forward_train(
    params: dict,
    bundle: RayBundle,
    config: FruitModelConfig,
    uniforms,
    step: int,
    train: bool,
) -> dict:
    """Train/eval forward. ``uniforms`` are the sampler's draws (see
    ``core.samplers.proposal_sample``), None in eval. Returns renders plus
    the (weights, sdist) histories the interlevel loss needs."""
    bundle = near_far_collider(bundle, config.near_plane, config.far_plane)
    return forward_collided(params, bundle, config, uniforms, step, train)


def forward_collided(
    params: dict,
    bundle: RayBundle,
    config: FruitModelConfig,
    uniforms,
    step: int,
    train: bool,
    anneal=None,
) -> dict:
    """``forward_train`` on a bundle whose near and far planes are set
    (``near_far_collider``), which the train step sets inside its ``rays``
    span. ``anneal``: the proposal anneal of a train step, a device scalar
    on the card (else ``proposal_anneal(step)``)."""
    updated = proposal_updated(step, config)

    def make_density_fn(i):
        def fn(positions):
            d = _proposal_forward(
                params["proposal_networks"][i], positions, config.proposal_nets[i]
            )
            return d if (updated or not train) else d.detach()

        return fn

    samples, weights_list, rs_list = proposal_sample(
        bundle,
        [make_density_fn(i) for i in range(len(config.proposal_nets))],
        config.num_proposal_samples,
        config.num_nerf_samples,
        train=train,
        uniforms=uniforms,
        anneal=(proposal_anneal(step, config) if anneal is None else anneal) if train else 1.0,
        initial_spacing=config.proposal_initial_sampler,
    )
    with span("field"):
        field_out = field_forward(
            params["field"], samples.positions(), bundle.directions,
            bundle.camera_indices, config.field, train=train,
        )
    with span("render"):
        weights = samples.get_weights(field_out["density"])
        weights_list.append(weights)
        rs_list.append(samples)
        sem = render_semantics(weights.detach(), field_out["semantics"])
        return {
            "rgb": render_rgb(weights, field_out["rgb"], config.background_color),
            "accumulation": render_accumulation(weights),
            "depth": render_depth_median(weights, samples),
            "semantics": sem,
            "semantics_colormap": semantic_colormap(sem, config.colormap_threshold),
            "weights_list": weights_list,
            "sdist_list": [rs.spacing_bins() for rs in rs_list],
        }


def forward_inference(params: dict, bundle: RayBundle, config: FruitModelConfig) -> dict:
    """Inference forward: the eval forward with the semantic colormap
    repeated to 3 channels for viewing."""
    out = forward_train(params, bundle, config, uniforms=None, step=1 << 30, train=False)
    out["semantics_colormap"] = out["semantics_colormap"].repeat_interleave(3, dim=-1)
    return out


def forward_export(
    params: dict,
    bundle: RayBundle,
    config: FruitModelConfig,
    num_samples: int,
    aabb: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Export forward: ``num_samples`` uniform deterministic samples a ray
    between the bundle's own near and far, the field with AABB
    normalization instead of the contraction and the mean appearance
    embedding, and raw per-sample outputs with no compositing."""
    samples = spaced_samples(bundle, num_samples, spacing="uniform", train=False)
    positions = samples.positions()
    field_out = field_forward(
        params["field"], positions, bundle.directions, bundle.camera_indices,
        config.field, train=False, contraction=False, aabb=aabb,
    )
    logit = field_out["semantics"][..., 0]
    return {
        "positions": positions,  # [R, S, 3]
        "rgb": field_out["rgb"],  # [R, S, 3]
        "semantics": logit,  # raw logits [R, S]
        "semantics_prob": torch.sigmoid(logit),
        "density": field_out["density"],  # [R, S]
    }


def loss_dict(
    outputs: dict, rgb_gt: torch.Tensor, mask_gt: torch.Tensor, config: FruitModelConfig
) -> dict[str, torch.Tensor]:
    sem_logits = outputs["semantics"][..., 0]
    losses = {
        "rgb_loss": L.rgb_mse(outputs["rgb"], rgb_gt),
        "semantics_loss": config.semantic_loss_weight
        * L.bce_with_logits(sem_logits, mask_gt),
        "interlevel_loss": config.interlevel_loss_mult
        * L.interlevel_loss(outputs["weights_list"], outputs["sdist_list"]),
    }
    if config.use_distortion_loss:
        losses["distortion_loss"] = config.distortion_loss_mult * L.distortion_loss(
            outputs["weights_list"], outputs["sdist_list"]
        )
    return losses


def metrics_dict(outputs: dict, rgb_gt: torch.Tensor) -> dict[str, torch.Tensor]:
    with torch.no_grad():
        mse = L.rgb_mse(outputs["rgb"], rgb_gt)
        return {
            "psnr": -10.0 * torch.log10(torch.clamp_min(mse, 1e-10)),
            "distortion": L.distortion_loss(outputs["weights_list"], outputs["sdist_list"]),
        }
