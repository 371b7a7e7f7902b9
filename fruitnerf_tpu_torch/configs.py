"""Training presets. Twin of ``fruitnerf_tpu/configs.py``: ``fruit_nerf``,
``fruit_nerf_big`` and ``fruit_nerf_huge``, each with the variants ``grid``
(the grid main field with the frequency-MLP proposals), ``tpu`` (a
frequency-encoded main field with no table, and the frequency-MLP
proposals) and ``parity`` (the reference's own network: a corner-mode hash
grid with two hash-grid proposal fields); the port's ``semantic_nerf``
preset (the reference's ``SemanticNeRFField`` at its published widths, the
``tpu`` variant only); and the ``fruit_nerf_smoke`` preset. MLP compute is
bfloat16 with float32 parameters and outputs on the production presets,
float32 on the smoke preset; the grid encodings compute in float32. Tests
shrink a preset with ``dataclasses.replace``.
"""
from __future__ import annotations

import dataclasses

import torch

from .fields.density_field import DensityFieldConfig
from .fields.encodings import GridEncodingConfig, HashEncodingConfig
from .fields.freq_density_field import FreqDensityFieldConfig
from .fields.fruit_field import FruitFieldConfig
from .fields.semantic_nerf_field import SemanticNerfFieldConfig
from .models.fruit_model import FruitModelConfig

TPU_PROPOSAL_NETS = (
    FreqDensityFieldConfig(num_frequencies=5, num_layers=2, hidden_dim=32),
    FreqDensityFieldConfig(num_frequencies=7, num_layers=3, hidden_dim=64),
)
VARIANTS = ("grid", "tpu", "parity")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Per-parameter-group Adam or RAdam with a continuous exponential lr
    decay over ``max_steps``, or the run's ``max_iters`` when that is None."""

    name: str = "adam"  # adam | radam
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
    # train on at most this many of the train images, evenly spaced
    # (engine.trainer.subsample_train_images); None keeps them all
    max_train_images: int | None = None
    seed: int = 42


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; choose from {list(VARIANTS)}")


def _encoding_for(variant: str) -> str:
    return {"tpu": "freq", "grid": "grid", "parity": "hash"}[variant]


def _hash_mode(variant: str) -> str:
    # the JAX presets' tpu variant names cell mode; its field has no table
    return "cell" if variant == "tpu" else "corner"


def fruit_nerf(
    num_images: int, compute_dtype: torch.dtype = torch.bfloat16, variant: str = "grid"
) -> TrainConfig:
    """Base preset: 30k iterations, 4096 rays a batch.

    ``variant="grid"``: the two-tier cell grid (16 levels, 16..2048, 4096
    rows on the 12 coarser levels and 8192 on the 4 finest) and the
    frequency-MLP proposals. ``variant="tpu"``: the frequency-encoded main
    field (12 octaves, no table) and the frequency-MLP proposals, every MLP
    group at the classic-NeRF rate. ``variant="parity"``: the corner-mode
    hash grid (16 levels, 2^19 entries, 16..2048) and the two hash
    DensityField proposals, every group at Adam 1e-2, as the reference
    trains it."""
    _check_variant(variant)
    field = FruitFieldConfig(
        num_images=num_images,
        hash=HashEncodingConfig(
            num_levels=16, log2_hashmap_size=19, base_res=16, max_res=2048,
            mode=_hash_mode(variant),
        ),
        grid=GridEncodingConfig(
            num_levels=16, table_size=8192, base_res=16, max_res=2048,
            mid_table_size=4096, fine_levels=4,
        ),
        encoding=_encoding_for(variant),
        pos_frequencies=12,
        hidden_dim=64,
        geo_feat_dim=15,
        hidden_dim_color=64,
        hidden_dim_semantic=64,
        appearance_embed_dim=32,
        compute_dtype=compute_dtype,
        density_bias=-3.0,
    )
    model = FruitModelConfig(field=field)
    if variant == "parity":
        extra = {}
    else:
        model = dataclasses.replace(model, proposal_nets=TPU_PROPOSAL_NETS)
        extra = dict(proposal_opt=TPU_MLP_OPT)
        if variant == "tpu":
            extra["fields_opt"] = TPU_MLP_OPT
    return TrainConfig(
        preset="fruit_nerf",
        model=model,
        max_iters=30000,
        train_rays_per_batch=4096,
        **extra,
    )


def _radam_groups(variant: str) -> dict:
    """The big and huge presets' fields and proposal groups: RAdam at 1e-2,
    the frequency MLPs at the classic-NeRF rate (1e-3 -> 1e-5)."""
    radam = OptimizerConfig(name="radam")
    slow = dataclasses.replace(radam, lr_init=1e-3, lr_final=1e-5)
    if variant == "tpu":
        return dict(fields_opt=slow, proposal_opt=slow)
    if variant == "grid":
        return dict(fields_opt=radam, proposal_opt=slow)
    return dict(fields_opt=radam, proposal_opt=radam)


def fruit_nerf_big(
    num_images: int, compute_dtype: torch.dtype = torch.bfloat16, variant: str = "grid",
    grid_table_size: int = 16384,
) -> TrainConfig:
    """Big preset: 100k iterations, 8192 rays, 128 fine samples, proposals
    (512, 256), hidden 128, geo features 30, 3 x 128 semantic layers,
    appearance 128, max_res 4096, anneal over 5000 steps, RAdam, split 0.99,
    200 train images. ``grid``: one uniform cell table of
    ``grid_table_size`` rows a level; ``parity``: a 2^21 corner hash grid."""
    _check_variant(variant)
    field = FruitFieldConfig(
        num_images=num_images,
        hash=HashEncodingConfig(
            num_levels=16, log2_hashmap_size=21, base_res=16, max_res=4096,
            mode=_hash_mode(variant),
        ),
        grid=GridEncodingConfig(
            num_levels=16, table_size=grid_table_size, base_res=16, max_res=4096,
        ),
        encoding=_encoding_for(variant),
        pos_frequencies=14,
        hidden_dim=128,
        geo_feat_dim=30,
        hidden_dim_color=128,
        num_layers_semantic=3,
        hidden_dim_semantic=128,
        appearance_embed_dim=128,
        compute_dtype=compute_dtype,
        density_bias=-3.0,
    )
    model = FruitModelConfig(
        field=field,
        num_nerf_samples=128,
        num_proposal_samples=(512, 256),
        proposal_weights_anneal_max_num_iters=5000,
    )
    if variant != "parity":
        model = dataclasses.replace(model, proposal_nets=TPU_PROPOSAL_NETS)
    return TrainConfig(
        preset="fruit_nerf_big",
        model=model,
        max_iters=100000,
        train_rays_per_batch=8192,
        train_split_fraction=0.99,
        max_train_images=200,
        **_radam_groups(variant),
    )


def fruit_nerf_huge(
    num_images: int, compute_dtype: torch.dtype = torch.bfloat16, variant: str = "grid",
    grid_table_size: int = 16384,
) -> TrainConfig:
    """Huge preset: 16384 rays, 64 fine samples, proposals (512, 512) through
    two 7-level 2^18 hash DensityFields (parity), hidden 256, max_res 8192;
    otherwise as the big preset."""
    _check_variant(variant)
    field = FruitFieldConfig(
        num_images=num_images,
        hash=HashEncodingConfig(
            num_levels=16, log2_hashmap_size=21, base_res=16, max_res=8192,
            mode=_hash_mode(variant),
        ),
        grid=GridEncodingConfig(
            num_levels=16, table_size=grid_table_size, base_res=16, max_res=8192,
        ),
        encoding=_encoding_for(variant),
        pos_frequencies=14,
        hidden_dim=256,
        geo_feat_dim=30,
        hidden_dim_color=256,
        num_layers_semantic=3,
        hidden_dim_semantic=128,
        appearance_embed_dim=128,
        compute_dtype=compute_dtype,
        density_bias=-3.0,
    )
    model = FruitModelConfig(
        field=field,
        num_nerf_samples=64,
        num_proposal_samples=(512, 512),
        proposal_nets=(
            DensityFieldConfig(
                hash=HashEncodingConfig(num_levels=7, log2_hashmap_size=18, base_res=16,
                                        max_res=256)
            ),
            DensityFieldConfig(
                hash=HashEncodingConfig(num_levels=7, log2_hashmap_size=18, base_res=16,
                                        max_res=512)
            ),
        ),
        proposal_weights_anneal_max_num_iters=5000,
    )
    if variant != "parity":
        model = dataclasses.replace(model, proposal_nets=TPU_PROPOSAL_NETS)
    return TrainConfig(
        preset="fruit_nerf_huge",
        model=model,
        max_iters=100000,
        train_rays_per_batch=16384,
        train_split_fraction=0.99,
        max_train_images=200,
        **_radam_groups(variant),
    )


def semantic_nerf(
    num_images: int, compute_dtype: torch.dtype = torch.bfloat16, variant: str = "tpu"
) -> TrainConfig:
    """The reference's ``SemanticNeRFField`` (meyerls/FruitNeRF
    ``fruit_field.py:310-410``, wired into no config there) at its published
    widths in ``FruitModel``: an 8 x 256 trunk on 10 position octaves whose
    5th layer takes the encoded position again, a 256 -> 1 density head, a
    colour head 283 -> 128 -> 3 on [trunk, 4 direction octaves] and a
    256 -> 64 -> 1 semantic branch on the detached trunk; FruitField's
    scene contraction, density bias -3. Otherwise the big preset's ``tpu``
    variant (8192 rays, 128 fine samples, frequency proposals (512, 256),
    RAdam 1e-3 -> 1e-5, split 0.99, 200 train images, 100k iterations) with
    the sparsity prior at 0.005. The field has no table, so ``tpu`` is its
    only variant; ``num_images`` sizes nothing (no appearance embedding)."""
    _check_variant(variant)
    if variant != "tpu":
        raise KeyError(f"the semantic_nerf preset has no table and takes the 'tpu' variant "
                       f"only, not {variant!r}")
    big = fruit_nerf_big(num_images, compute_dtype, variant="tpu")
    field = SemanticNerfFieldConfig(
        num_layers_base=8,
        hidden_dim=256,
        num_layers_semantic=2,
        hidden_dim_semantic=64,
        pos_frequencies=10,
        dir_frequencies=4,
        compute_dtype=compute_dtype,
        skip_layers=(4,),
        scene_contraction=True,
        density_bias=-3.0,
    )
    model = dataclasses.replace(big.model, field=field, density_sparsity_mult=0.005)
    return dataclasses.replace(big, preset="semantic_nerf", model=model)


def fruit_nerf_smoke(num_images: int, compute_dtype: torch.dtype = torch.float32) -> TrainConfig:
    """Tiny preset for CPU tests and smoke runs: small hash tables, few
    samples, a white background, 500 iterations. It takes no variant."""
    field = FruitFieldConfig(
        num_images=num_images,
        hash=HashEncodingConfig(num_levels=8, log2_hashmap_size=13, base_res=4, max_res=128),
        encoding="hash",
        hidden_dim=32,
        geo_feat_dim=15,
        hidden_dim_color=32,
        hidden_dim_semantic=32,
        appearance_embed_dim=8,
        compute_dtype=compute_dtype,
    )
    model = FruitModelConfig(
        field=field,
        num_nerf_samples=24,
        num_proposal_samples=(48, 32),
        proposal_nets=(
            DensityFieldConfig(
                hash=HashEncodingConfig(num_levels=4, log2_hashmap_size=11, base_res=4, max_res=64)
            ),
            DensityFieldConfig(
                hash=HashEncodingConfig(num_levels=4, log2_hashmap_size=11, base_res=4, max_res=128)
            ),
        ),
        near_plane=0.05,
        far_plane=6.0,
        background_color="white",
        proposal_weights_anneal_max_num_iters=200,
        proposal_warmup=200,
    )
    return TrainConfig(
        preset="fruit_nerf_smoke",
        model=model,
        max_iters=500,
        train_rays_per_batch=1024,
        eval_rays_per_chunk=2048,
        steps_per_save=250,
        steps_per_eval=250,
    )


PRESETS = {
    "fruit_nerf": fruit_nerf,
    "fruit_nerf_big": fruit_nerf_big,
    "fruit_nerf_huge": fruit_nerf_huge,
    "fruit_nerf_smoke": fruit_nerf_smoke,
    "semantic_nerf": semantic_nerf,
}


def get_preset(name: str, num_images: int, **kw) -> TrainConfig:
    """A preset by name, as the JAX package's ``get_preset``; ``kw`` goes to
    the preset (``variant`` and ``compute_dtype``, and ``grid_table_size``
    for the big and huge presets; the smoke preset takes no variant, the
    port's ``semantic_nerf`` the ``tpu`` one alone)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name](num_images, **kw)


def run_preset(name: str, num_images: int, variant: str) -> TrainConfig:
    """The preset an entry point builds from its ``--preset`` and
    ``--variant``: the smoke preset takes no variant, so it is dropped
    there (the JAX scripts branch on the name likewise)."""
    if name == "fruit_nerf_smoke":
        return get_preset(name, num_images)
    return get_preset(name, num_images, variant=variant)


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
        if config.model.field.encoding != "grid":
            raise ValueError(
                f"grid overrides {sorted(k for k in _GRID_OVERRIDE_KEYS if k in ov)} apply to "
                f"the grid variant's table; this config encodes with "
                f"{config.model.field.encoding!r} (its table is fixed by the preset)"
            )
        field["grid"] = dataclasses.replace(config.model.field.grid, **grid)
    if field:
        model["field"] = dataclasses.replace(config.model.field, **field)
    if model:
        train["model"] = dataclasses.replace(config.model, **model)
    if train:
        config = dataclasses.replace(config, **train)
    return config
