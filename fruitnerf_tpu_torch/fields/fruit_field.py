"""FruitField: grid NeRF with RGB, density and a binary semantic head. Twin
of ``fruitnerf_tpu/fields/fruit_field.py``:

  positions --contract(inf)--> [0,1]^3 --grid, hash grid or frequencies--> base MLP
      -> density (trunc_exp, f32) + geo features
  [SH(dir), geo, appearance embedding] -> color MLP -> sigmoid RGB
  detached geo -> semantic MLP -> linear head -> 1 fruit logit

Appearance embeddings are indexed per training image; eval uses their mean.
The ``freq`` encoding (the ``tpu`` variant's) has no table: octave sines
and cosines of the position feed a base MLP of at least four layers.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import contract_to_unit, normalize_aabb_to_unit, trunc_exp
from .encodings import (
    GridEncodingConfig,
    HashEncodingConfig,
    grid_encode,
    hash_encode,
    init_grid_table,
    init_hash_table,
    nerf_encode,
    sh_encode,
)
from .mlp import MLPConfig, apply_mlp, init_mlp

# the parameter that holds each encoding's table; the freq encoding has none
TABLE_KEYS = {"grid": "grid_table", "hash": "hash_table", "freq": None}


@dataclasses.dataclass(frozen=True)
class FruitFieldConfig:
    num_images: int
    hash: HashEncodingConfig = HashEncodingConfig()
    grid: GridEncodingConfig = GridEncodingConfig()
    # "grid": the grid variant's multiresolution grid; "hash": the
    # instant-ngp hash grid (the parity variant and the smoke preset);
    # "freq": octave frequencies of the position (the tpu variant). The JAX
    # twin defaults to "hash"; the port keeps "grid", its first preset's.
    encoding: str = "grid"
    pos_frequencies: int = 12  # the freq encoding's octaves
    num_layers_base: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_semantic: int = 2
    hidden_dim_semantic: int = 64
    num_semantic_classes: int = 1
    appearance_embed_dim: int = 32
    sh_levels: int = 4
    compute_dtype: torch.dtype = torch.float32
    # added to the raw density logit before trunc_exp (-3: start empty)
    density_bias: float = 0.0

    def __post_init__(self):
        if self.encoding not in TABLE_KEYS:
            raise ValueError(
                f"FruitField encoding {self.encoding!r}: choose from {sorted(TABLE_KEYS)}"
            )

    @property
    def encoding_config(self) -> GridEncodingConfig | HashEncodingConfig | None:
        """The config of the table in use; None for the freq encoding."""
        return {"grid": self.grid, "hash": self.hash, "freq": None}[self.encoding]

    @property
    def table_key(self) -> str | None:
        return TABLE_KEYS[self.encoding]

    @property
    def base_in_dim(self) -> int:
        if self.encoding == "freq":
            return 3 + 3 * 2 * self.pos_frequencies
        return self.encoding_config.out_dim

    @property
    def base_num_layers(self) -> int:
        # a frequency MLP needs depth to make up for the missing grid capacity
        if self.encoding == "freq":
            return max(self.num_layers_base, 4)
        return self.num_layers_base

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.base_in_dim,
            num_layers=self.base_num_layers,
            hidden_dim=self.hidden_dim,
            out_dim=1 + self.geo_feat_dim,
        )

    @property
    def color_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.sh_levels**2 + self.geo_feat_dim + self.appearance_embed_dim,
            num_layers=self.num_layers_color,
            hidden_dim=self.hidden_dim_color,
            out_dim=3,
            out_sigmoid=True,
        )

    @property
    def semantic_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.geo_feat_dim,
            num_layers=self.num_layers_semantic,
            hidden_dim=self.hidden_dim_semantic,
            out_dim=self.hidden_dim_semantic,
        )

    @property
    def semantic_head(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.hidden_dim_semantic,
            num_layers=1,
            hidden_dim=self.hidden_dim_semantic,
            out_dim=self.num_semantic_classes,
        )


def init_fruit_field(
    config: FruitFieldConfig, generator: torch.Generator, device
) -> dict:
    params = {}
    if config.table_key is not None:
        init_table = init_hash_table if config.encoding == "hash" else init_grid_table
        params[config.table_key] = init_table(config.encoding_config, generator, device)
    return {
        **params,
        "base_mlp": init_mlp(config.base_mlp, generator, device),
        "color_mlp": init_mlp(config.color_mlp, generator, device),
        "semantic_mlp": init_mlp(config.semantic_mlp, generator, device),
        "semantic_head": init_mlp(config.semantic_head, generator, device),
        "appearance": torch.randn(
            (config.num_images, config.appearance_embed_dim),
            generator=generator, device=device,
        ),
    }


def get_density(
    params: dict,
    positions: torch.Tensor,
    config: FruitFieldConfig,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """World positions [..., 3] -> (density [...], geo features [..., G]).
    ``contraction=False`` normalizes by ``aabb`` ([2, 3]) instead: the
    export path's input map."""
    if contraction:
        pos01, selector = contract_to_unit(positions)
    else:
        if aabb is None:
            raise ValueError("get_density(contraction=False) needs an aabb")
        pos01, selector = normalize_aabb_to_unit(positions, aabb)
    if config.encoding == "freq":
        h = nerf_encode(pos01 * 2.0 - 1.0, config.pos_frequencies)
    else:
        encode = hash_encode if config.encoding == "hash" else grid_encode
        h = encode(params[config.table_key], pos01, config.encoding_config)
    out = apply_mlp(params["base_mlp"], h, config.base_mlp, config.compute_dtype)
    density = trunc_exp(out[..., 0] + config.density_bias) * selector
    return density, out[..., 1:]


def get_appearance(params: dict, camera_indices: torch.Tensor, train: bool) -> torch.Tensor:
    """[R] camera indices -> [R, A] appearance vectors; eval uses the mean
    embedding."""
    emb = params["appearance"]
    if train:
        return emb[camera_indices]
    return torch.mean(emb, dim=0).expand(camera_indices.shape[0], emb.shape[1])


def fruit_field_forward(
    params: dict,
    positions: torch.Tensor,  # [R, S, 3]
    directions: torch.Tensor,  # [R, 3] unit
    camera_indices: torch.Tensor,  # [R]
    config: FruitFieldConfig,
    train: bool,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Full field pass -> density [R,S], rgb [R,S,3], semantics [R,S,C]."""
    density, geo = get_density(params, positions, config, contraction, aabb)
    r, s = positions.shape[0], positions.shape[1]
    sh = sh_encode(directions, config.sh_levels)[:, None, :].expand(r, s, -1)
    app = get_appearance(params, camera_indices, train)[:, None, :].expand(r, s, -1)
    color_in = torch.cat([sh, geo, app], dim=-1)
    rgb = apply_mlp(params["color_mlp"], color_in, config.color_mlp, config.compute_dtype)
    sem_h = apply_mlp(
        params["semantic_mlp"], geo.detach(), config.semantic_mlp, config.compute_dtype
    )
    semantics = apply_mlp(
        params["semantic_head"], sem_h, config.semantic_head, config.compute_dtype
    )
    return {"density": density, "rgb": rgb, "semantics": semantics}
