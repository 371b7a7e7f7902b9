"""SemanticNeRFField: a classic frequency-encoded MLP NeRF with a semantic
branch. Twin of ``fruitnerf_tpu/fields/semantic_nerf_field.py``: a
positional-encoding MLP trunk, a density head, a direction-conditioned RGB
head and a small semantic branch on the detached trunk features.

The config's defaults are the twin's (a 4 x 128 trunk, no skip, positions
encoded as they are). The ``semantic_nerf`` preset (``configs.py``) runs the
reference's published widths (meyerls/FruitNeRF ``fruit_field.py:310-410``):
an 8 x 256 trunk whose 5th layer takes the encoded input again (nerfstudio's
``NeRFField``, ``skip_connections=(4,)``), 10 position and 4 direction
octaves, with FruitField's scene contraction and box selector
(``scene_contraction``), as ``FruitModel``'s sampler reaches far past the
unit cube. Each product takes its joined input as published (``mlp.py``
says why the skip layer is not split).

Spans: ``field.trunk`` (the position map, the encoding and the trunk) and
``field.heads`` (the density, colour and semantic heads), nested in the
caller's ``field`` or ``sparsity`` span.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import contract_to_unit, normalize_aabb_to_unit, trunc_exp
from ..utils.profiling import span
from .encodings import GridEncodingConfig, HashEncodingConfig, nerf_encode
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
    # trunk layers that take the encoded position again (the published (4,))
    skip_layers: tuple = ()
    # True: FruitField's map of world positions (the contraction, zero
    # density outside its cube); False: positions encoded as they are
    scene_contraction: bool = False
    # added to the raw density before trunc_exp (-3: start empty)
    density_bias: float = 0.0
    # unused (the field has no table): carried so that the field's config has
    # the two layouts every preset's field has, which the benchmark's shrunk
    # test copy (port_bench/tests/tiny.py) shrinks in every configuration
    hash: HashEncodingConfig = HashEncodingConfig()
    grid: GridEncodingConfig = GridEncodingConfig()

    encoding = "freq"  # no table: the run's manifest records none
    encoding_config = None

    @property
    def pos_dim(self) -> int:
        return 3 + 3 * 2 * self.pos_frequencies

    @property
    def dir_dim(self) -> int:
        return 3 + 3 * 2 * self.dir_frequencies

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(self.pos_dim, self.num_layers_base, self.hidden_dim, self.hidden_dim,
                         skips=self.skip_layers)

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


def _trunk(params, positions, config, contraction, aabb):
    """-> (ReLU trunk features [..., W] in the compute dtype, the selector
    or None). ``contraction=False`` normalizes by ``aabb`` instead: the
    export path's input map."""
    dt = config.compute_dtype
    with span("field.trunk"):
        selector = None
        if not contraction:
            if aabb is None:
                raise ValueError("the field's contraction=False path needs an aabb")
            pos01, selector = normalize_aabb_to_unit(positions, aabb)
            positions = pos01 * 2.0 - 1.0
        elif config.scene_contraction:
            pos01, selector = contract_to_unit(positions)
            positions = pos01 * 2.0 - 1.0
        # written once in the MLP's dtype, the bits apply_mlp's cast would give
        enc = nerf_encode(positions, config.pos_frequencies, dt)
        h = apply_mlp(params["base_mlp"], enc, config.base_mlp, dt, out_dtype=dt)
        return torch.relu(h), selector


def _density(params, h, selector, config):
    raw = apply_mlp(params["density_head"], h, config.density_head, config.compute_dtype)
    density = trunc_exp(raw[..., 0] + config.density_bias)
    return density if selector is None else density * selector


def get_density(
    params: dict,
    positions: torch.Tensor,
    config: SemanticNerfFieldConfig,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> torch.Tensor:
    """World positions [..., 3] -> density [...]: the trunk and the density
    head alone (the sparsity prior's path)."""
    h, selector = _trunk(params, positions, config, contraction, aabb)
    with span("field.heads"):
        return _density(params, h, selector, config)


def semantic_nerf_forward(
    params: dict,
    positions: torch.Tensor,  # [R, S, 3]
    directions: torch.Tensor,  # [R, 3]
    config: SemanticNerfFieldConfig,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """-> density [R,S], rgb [R,S,3], semantics [R,S,C]."""
    dt = config.compute_dtype
    h, selector = _trunk(params, positions, config, contraction, aabb)
    with span("field.heads"):
        density = _density(params, h, selector, config)
        # cast after the broadcast, so that the samples' gradients of a ray's
        # directions add up in float32
        dir_enc = nerf_encode(directions, config.dir_frequencies)
        dir_enc = dir_enc[:, None, :].expand(-1, positions.shape[-2], -1).to(dt)
        rgb = apply_mlp(params["color_mlp"], torch.cat([h, dir_enc], dim=-1), config.color_mlp,
                        dt)
        sem_in = h if config.pass_semantic_gradients else h.detach()
        semantics = apply_mlp(params["semantic_mlp"], sem_in, config.semantic_mlp, dt)
        return {"density": density, "rgb": rgb, "semantics": semantics}
