"""Frequency-MLP proposal density field. Twin of
``fruitnerf_tpu/fields/freq_density_field.py``: octave frequency encoding of
the contracted position, a small MLP, trunc_exp density zeroed outside the
contraction's unit cube."""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import contract_to_unit, trunc_exp
from .encodings import nerf_encode
from .mlp import MLPConfig, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FreqDensityFieldConfig:
    num_frequencies: int = 6
    num_layers: int = 3
    hidden_dim: int = 64
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def in_dim(self) -> int:
        return 3 + 3 * 2 * self.num_frequencies

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.in_dim,
            num_layers=self.num_layers,
            hidden_dim=self.hidden_dim,
            out_dim=1,
        )


def init_freq_density_field(
    config: FreqDensityFieldConfig, generator: torch.Generator, device
) -> dict:
    return {"mlp": init_mlp(config.mlp, generator, device)}


def freq_density_field_forward(
    params: dict, positions: torch.Tensor, config: FreqDensityFieldConfig
) -> torch.Tensor:
    """positions [..., 3] (world) -> density [...]."""
    pos01, selector = contract_to_unit(positions)
    # written once in the MLP's dtype, the bits apply_mlp's cast would give
    enc = nerf_encode(pos01 * 2.0 - 1.0, config.num_frequencies, config.compute_dtype)
    out = apply_mlp(params["mlp"], enc, config.mlp, config.compute_dtype)
    return trunc_exp(out[..., 0]) * selector
