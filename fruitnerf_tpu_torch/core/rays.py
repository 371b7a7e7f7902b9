"""Ray containers. Twin of ``fruitnerf_tpu/core/rays.py``: a leading ray
axis [R]; samples add a sample axis [R, S]."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """A batch of rays. origins/directions: [R,3]; nears/fars: [R]."""

    origins: torch.Tensor
    directions: torch.Tensor  # unit-norm
    nears: torch.Tensor
    fars: torch.Tensor
    camera_indices: torch.Tensor  # [R] int64

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **kw) -> "RayBundle":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, sl: slice) -> "RayBundle":
        return RayBundle(
            *(getattr(self, f.name)[sl] for f in dataclasses.fields(self))
        )

    def to(self, device) -> "RayBundle":
        return RayBundle(
            *(getattr(self, f.name).to(device) for f in dataclasses.fields(self))
        )


@dataclasses.dataclass(frozen=True)
class RaySamples:
    """Samples along rays: normalized spacing bins in [0,1] and euclidean
    starts/ends along each unit direction, [R, S] throughout."""

    bundle: RayBundle
    spacing_starts: torch.Tensor
    spacing_ends: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def midpoints(self) -> torch.Tensor:
        return 0.5 * (self.starts + self.ends)

    def positions(self) -> torch.Tensor:
        """[R, S, 3] world-space sample positions at bin midpoints."""
        return (
            self.bundle.origins[:, None, :]
            + self.bundle.directions[:, None, :] * self.midpoints[..., None]
        )

    def spacing_bins(self) -> torch.Tensor:
        """[R, S+1] normalized bin edges."""
        return torch.cat([self.spacing_starts, self.spacing_ends[:, -1:]], dim=-1)

    def get_weights(self, density: torch.Tensor) -> torch.Tensor:
        return render_weights_from_density(density, self.deltas)


def render_weights_from_density(
    density: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """alpha_i = 1-exp(-sigma_i*delta_i), w_i = alpha_i * prod_{j<i}(1-alpha_j)."""
    delta_density = density * deltas
    alphas = 1.0 - torch.exp(-delta_density)
    trans = torch.exp(-torch.cumsum(delta_density, dim=-1) + delta_density)
    return alphas * trans


def near_far_collider(bundle: RayBundle, near: float, far: float) -> RayBundle:
    """Constant near/far planes."""
    r = bundle.num_rays
    like = bundle.origins
    return bundle.replace(
        nears=torch.full((r,), near, dtype=like.dtype, device=like.device),
        fars=torch.full((r,), far, dtype=like.dtype, device=like.device),
    )
