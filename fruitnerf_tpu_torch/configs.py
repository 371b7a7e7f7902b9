"""Training presets. Twin of ``fruitnerf_tpu/configs.py`` for the
``fruit_nerf`` preset's ``grid`` variant: the grid main field with the
frequency-MLP proposals. MLP compute is bfloat16 with float32 parameters
and outputs. Tests shrink the preset with ``dataclasses.replace``.
"""
from __future__ import annotations

import dataclasses

import torch

from .fields.encodings import GridEncodingConfig
from .fields.freq_density_field import FreqDensityFieldConfig
from .fields.fruit_field import FruitFieldConfig
from .models.fruit_model import FruitModelConfig

TPU_PROPOSAL_NETS = (
    FreqDensityFieldConfig(num_frequencies=5, num_layers=2, hidden_dim=32),
    FreqDensityFieldConfig(num_frequencies=7, num_layers=3, hidden_dim=64),
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Per-parameter-group Adam with a continuous exponential lr decay over
    ``max_steps``, or the run's ``max_iters`` when that is None (RAdam,
    which the big and huge presets use, is still to port)."""

    lr_init: float = 1e-2
    lr_final: float = 1e-4
    eps: float = 1e-15
    max_steps: int | None = None  # None -> the run's max_iters
    warmup_steps: int = 0  # lr held at 0 until this step
    weight_decay: float = 0.0  # decoupled, scaled by the lr (AdamW)


# classic-NeRF rates for the frequency MLPs
TPU_MLP_OPT = OptimizerConfig(lr_init=1e-3, lr_final=1e-5)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    preset: str
    model: FruitModelConfig
    max_iters: int = 30000
    train_rays_per_batch: int = 4096
    eval_rays_per_chunk: int = 1 << 15
    steps_per_save: int = 2000
    steps_per_eval: int = 500
    steps_per_log: int = 100
    fields_opt: OptimizerConfig = OptimizerConfig()
    proposal_opt: OptimizerConfig = OptimizerConfig()
    # appearance embeddings: lower lr and decoupled decay keep them near the
    # mean embedding that eval uses
    appearance_opt: OptimizerConfig = OptimizerConfig(
        lr_init=1e-3, lr_final=1e-4, weight_decay=1e-2
    )
    # camera-opt is held at lr 0 until the geometry settles
    camera_opt: OptimizerConfig = OptimizerConfig(
        lr_init=6e-4, lr_final=6e-5, warmup_steps=2500
    )
    use_camera_opt: bool = True
    # rays sweep their pixel's footprint instead of its centre line
    train_subpixel_jitter: bool = True
    # share of a capture's images trained on; the rest are held out
    train_split_fraction: float = 0.9
    seed: int = 42


def fruit_nerf(
    num_images: int, compute_dtype: torch.dtype = torch.bfloat16, variant: str = "grid"
) -> TrainConfig:
    """Base preset: 30k iterations, 4096 rays a batch, the two-tier cell grid
    (16 levels, 16..2048, 4096 rows on the 12 coarser levels and 8192 on the
    4 finest) and the frequency-MLP proposals."""
    if variant != "grid":
        raise NotImplementedError(
            f"fruit_nerf variant {variant!r}: only 'grid' is ported "
            "(the other variants are ROADMAP Queue 1 item 12)"
        )
    field = FruitFieldConfig(
        num_images=num_images,
        grid=GridEncodingConfig(
            num_levels=16, table_size=8192, base_res=16, max_res=2048,
            mid_table_size=4096, fine_levels=4,
        ),
        hidden_dim=64,
        geo_feat_dim=15,
        hidden_dim_color=64,
        hidden_dim_semantic=64,
        appearance_embed_dim=32,
        compute_dtype=compute_dtype,
        density_bias=-3.0,
    )
    return TrainConfig(
        preset="fruit_nerf",
        model=FruitModelConfig(field=field, proposal_nets=TPU_PROPOSAL_NETS),
        max_iters=30000,
        train_rays_per_batch=4096,
        proposal_opt=TPU_MLP_OPT,
    )


def get_preset(name: str, num_images: int, variant: str = "grid") -> TrainConfig:
    """A preset by name, as the JAX package's ``get_preset``. Only
    ``fruit_nerf``'s ``grid`` variant is ported; the JAX package's other
    presets (``fruit_nerf_big``, ``_huge``, ``_smoke``) and variants raise
    NotImplementedError."""
    if name != "fruit_nerf":
        raise NotImplementedError(
            f"preset {name!r}: only 'fruit_nerf' is ported "
            "(the other presets are ROADMAP Queue 1 item 12)"
        )
    return fruit_nerf(num_images, variant=variant)


# Flat override keys, as recorded in a run's manifest (the JAX twin's
# OVERRIDE_KEYS); every check is ``is not None`` so zero/False apply.
_GRID_OVERRIDE_KEYS = {
    "table_size": "table_size",
    "grid_levels": "num_levels",
    "mid_table_size": "mid_table_size",
    "fine_levels": "fine_levels",
}
_MODEL_OVERRIDE_KEYS = {
    "nerf_samples": "num_nerf_samples",
    "distortion_loss": "use_distortion_loss",
    "sparsity_loss": "density_sparsity_mult",
    "sparsity_boost": "sparsity_unobserved_boost",
    "sparsity_points": "sparsity_num_points",
    "sparsity_cell": "sparsity_cell",
}
_FIELD_OVERRIDE_KEYS = {"density_bias": "density_bias"}
_TRAIN_OVERRIDE_KEYS = {
    "train_rays_per_batch": "train_rays_per_batch",
    "camera_opt": "use_camera_opt",
    "subpixel_jitter": "train_subpixel_jitter",
}
OVERRIDE_KEYS = (
    set(_GRID_OVERRIDE_KEYS) | set(_MODEL_OVERRIDE_KEYS)
    | set(_FIELD_OVERRIDE_KEYS) | set(_TRAIN_OVERRIDE_KEYS)
)


def apply_overrides(config: TrainConfig, overrides: dict) -> TrainConfig:
    """Apply a flat override dict (see OVERRIDE_KEYS) to a preset config."""
    unknown = set(overrides) - OVERRIDE_KEYS
    if unknown:
        raise KeyError(f"unknown config overrides: {sorted(unknown)}")
    ov = {k: v for k, v in overrides.items() if v is not None}
    grid = {dst: ov[src] for src, dst in _GRID_OVERRIDE_KEYS.items() if src in ov}
    field = {dst: ov[src] for src, dst in _FIELD_OVERRIDE_KEYS.items() if src in ov}
    model = {dst: ov[src] for src, dst in _MODEL_OVERRIDE_KEYS.items() if src in ov}
    train = {dst: ov[src] for src, dst in _TRAIN_OVERRIDE_KEYS.items() if src in ov}
    if grid:
        field["grid"] = dataclasses.replace(config.model.field.grid, **grid)
    if field:
        model["field"] = dataclasses.replace(config.model.field, **field)
    if model:
        train["model"] = dataclasses.replace(config.model, **model)
    if train:
        config = dataclasses.replace(config, **train)
    return config
