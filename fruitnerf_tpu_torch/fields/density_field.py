"""The hash-grid proposal density field (nerfstudio's HashMLPDensityField).
Twin of ``fruitnerf_tpu/fields/density_field.py``: a small hash grid (5
levels, 2^17 entries, resolutions 16..128 by default), a 2-layer hidden-16
MLP (or one linear layer with ``use_linear``), trunc_exp density zeroed by
the contraction's or the AABB's selector."""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import contract_to_unit, normalize_aabb_to_unit, trunc_exp
from .encodings import HashEncodingConfig, hash_encode, init_hash_table
from .mlp import MLPConfig, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class DensityFieldConfig:
    hash: HashEncodingConfig = HashEncodingConfig(
        num_levels=5, log2_hashmap_size=17, base_res=16, max_res=128
    )
    num_layers: int = 2
    hidden_dim: int = 16
    use_linear: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.hash.out_dim,
            num_layers=1 if self.use_linear else self.num_layers,
            hidden_dim=self.hidden_dim,
            out_dim=1,
        )


def init_density_field(
    config: DensityFieldConfig, generator: torch.Generator, device
) -> dict:
    return {
        "hash_table": init_hash_table(config.hash, generator, device),
        "mlp": init_mlp(config.mlp, generator, device),
    }


def density_field_forward(
    params: dict,
    positions: torch.Tensor,
    config: DensityFieldConfig,
    contraction: bool = True,
    aabb: torch.Tensor | None = None,
) -> torch.Tensor:
    """World positions [..., 3] -> density [...]."""
    if contraction:
        pos01, selector = contract_to_unit(positions)
    else:
        if aabb is None:
            raise ValueError("density_field_forward(contraction=False) needs an aabb")
        pos01, selector = normalize_aabb_to_unit(positions, aabb)
    h = hash_encode(params["hash_table"], pos01, config.hash)
    out = apply_mlp(params["mlp"], h, config.mlp, config.compute_dtype)
    return trunc_exp(out[..., 0]) * selector
