"""SemanticNeRFField: a classic frequency-encoded MLP NeRF with a semantic
branch. Twin of ``fruitnerf_tpu/fields/semantic_nerf_field.py``: a
positional-encoding MLP, a density head, a direction-conditioned RGB head
and a small semantic branch on the detached features. As in the reference,
no preset uses it; it stands alone as a hash-free baseline.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import trunc_exp
from .encodings import nerf_encode
from .mlp import MLPConfig, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class SemanticNerfFieldConfig:
    num_layers_base: int = 4
    hidden_dim: int = 128
    num_layers_semantic: int = 2
    hidden_dim_semantic: int = 64
    pos_frequencies: int = 10
    dir_frequencies: int = 4
    num_semantic_classes: int = 1
    pass_semantic_gradients: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def pos_dim(self) -> int:
        return 3 + 3 * 2 * self.pos_frequencies

    @property
    def dir_dim(self) -> int:
        return 3 + 3 * 2 * self.dir_frequencies

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(self.pos_dim, self.num_layers_base, self.hidden_dim, self.hidden_dim)

    @property
    def density_head(self) -> MLPConfig:
        return MLPConfig(self.hidden_dim, 1, self.hidden_dim, 1)

    @property
    def color_mlp(self) -> MLPConfig:
        return MLPConfig(self.hidden_dim + self.dir_dim, 2, self.hidden_dim // 2, 3,
                         out_sigmoid=True)

    @property
    def semantic_mlp(self) -> MLPConfig:
        return MLPConfig(self.hidden_dim, self.num_layers_semantic, self.hidden_dim_semantic,
                         self.num_semantic_classes)


def init_semantic_nerf_field(
    config: SemanticNerfFieldConfig, generator: torch.Generator, device
) -> dict:
    return {
        "base_mlp": init_mlp(config.base_mlp, generator, device),
        "density_head": init_mlp(config.density_head, generator, device),
        "color_mlp": init_mlp(config.color_mlp, generator, device),
        "semantic_mlp": init_mlp(config.semantic_mlp, generator, device),
    }


def semantic_nerf_forward(
    params: dict,
    positions: torch.Tensor,  # [R, S, 3]
    directions: torch.Tensor,  # [R, 3]
    config: SemanticNerfFieldConfig,
) -> dict[str, torch.Tensor]:
    """-> density [R,S], rgb [R,S,3], semantics [R,S,C]."""
    dt = config.compute_dtype
    h = torch.relu(apply_mlp(params["base_mlp"], nerf_encode(positions, config.pos_frequencies),
                             config.base_mlp, dt))
    density = trunc_exp(apply_mlp(params["density_head"], h, config.density_head, dt)[..., 0])
    dir_enc = nerf_encode(directions, config.dir_frequencies)
    dir_enc = dir_enc[:, None, :].expand(-1, positions.shape[-2], -1)
    rgb = apply_mlp(params["color_mlp"], torch.cat([h, dir_enc], dim=-1), config.color_mlp, dt)
    sem_in = h if config.pass_semantic_gradients else h.detach()
    semantics = apply_mlp(params["semantic_mlp"], sem_in, config.semantic_mlp, dt)
    return {"density": density, "rgb": rgb, "semantics": semantics}
