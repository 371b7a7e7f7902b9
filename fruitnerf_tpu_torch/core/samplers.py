"""Ray samplers: spaced (uniform / piecewise), PDF, and proposal.
Twin of ``fruitnerf_tpu/core/samplers.py``.

Where the JAX twin takes a PRNG key, these take the uniform draws
themselves (``uniforms``: [R, 1], one jitter per ray, the twin's single
jitter; or one per bin, [R, n+1] for the spaced sampler and [R, N+1] for a
PDF resampling), so a caller makes every random draw of a step in one place
(``engine.trainer.draw_step``) and a test can inject the JAX draws. As in
the JAX twin, gradients flow through the resampled bins.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils.profiling import span
from .math import batched_searchsorted, take_sorted
from .rays import RayBundle, RaySamples


def _uniform_fn(t):
    return t


def _piecewise_fn(t):
    # uniform in [0,1), linear-in-disparity beyond 1
    return torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp_min(t, 1e-12)))


def _piecewise_inv(s):
    return torch.where(s < 0.5, 2.0 * s, 1.0 / torch.clamp_min(2.0 - 2.0 * s, 1e-12))


SPACINGS = {
    "uniform": (_uniform_fn, _uniform_fn),
    "piecewise": (_piecewise_fn, _piecewise_inv),
}


def spacing_to_euclidean(s: torch.Tensor, bundle: RayBundle, spacing: str) -> torch.Tensor:
    """Normalized s in [0,1] ([R, K]) -> euclidean t given per-ray near/far."""
    fn, inv = SPACINGS[spacing]
    s_near = fn(bundle.nears)[:, None]
    s_far = fn(bundle.fars)[:, None]
    return inv(s * s_far + (1.0 - s) * s_near)


def ray_samples_from_spacing_bins(
    bundle: RayBundle, s_bins: torch.Tensor, spacing: str
) -> RaySamples:
    """RaySamples from [R, S+1] normalized bin edges."""
    t_bins = spacing_to_euclidean(s_bins, bundle, spacing)
    return RaySamples(
        bundle=bundle,
        spacing_starts=s_bins[:, :-1],
        spacing_ends=s_bins[:, 1:],
        starts=t_bins[:, :-1],
        ends=t_bins[:, 1:],
    )


def spaced_samples(
    bundle: RayBundle,
    num_samples: int,
    spacing: str = "uniform",
    train: bool = False,
    uniforms: torch.Tensor | None = None,
) -> RaySamples:
    """Evenly spaced bins in s-space, stratified-jittered by ``uniforms``
    ([R, 1] or [R, num_samples+1]) only in training."""
    r = bundle.num_rays
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=bundle.origins.device)
    s_bins = edges.expand(r, num_samples + 1)
    if train and uniforms is not None:
        bin_centers = (s_bins[:, 1:] + s_bins[:, :-1]) / 2.0
        bin_upper = torch.cat([bin_centers, s_bins[:, -1:]], dim=-1)
        bin_lower = torch.cat([s_bins[:, :1], bin_centers], dim=-1)
        s_bins = bin_lower + (bin_upper - bin_lower) * uniforms
    return ray_samples_from_spacing_bins(bundle, s_bins, spacing)


def pdf_sample_bins(
    s_bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    train: bool,
    uniforms: torch.Tensor | None,
    histogram_padding: float = 0.01,
) -> torch.Tensor:
    """Resample [R, S+1] bins by inverse CDF of [R, S] weights -> [R, N+1].
    ``uniforms`` ([R, 1] or [R, N+1], in [0,1)) jitter the CDF queries in
    training."""
    num_bins = num_samples + 1
    w = weights + histogram_padding
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    pad = torch.clamp_min(1e-5 - w_sum, 0.0)
    w = w + pad / w.shape[-1]
    w_sum = w_sum + pad
    pdf = w / w_sum
    cdf = torch.clamp_max(torch.cumsum(pdf[:, :-1], dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], dim=-1)

    r = s_bins.shape[0]
    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=s_bins.device)
    if train and uniforms is not None:
        u = u.expand(r, num_bins) + uniforms / num_bins
    else:
        u = (u + 0.5 / num_bins).expand(r, num_bins)

    inds = batched_searchsorted(cdf, u, side="right")
    below = torch.clamp(inds - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(inds, 0, cdf.shape[-1] - 1)
    cdf_g0 = take_sorted(cdf, below)
    cdf_g1 = take_sorted(cdf, above)
    bins_g0 = take_sorted(s_bins, below)
    bins_g1 = take_sorted(s_bins, above)
    t = torch.clamp((u - cdf_g0) / torch.clamp_min(cdf_g1 - cdf_g0, 1e-12), 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def proposal_sample(
    bundle: RayBundle,
    density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    num_proposal_samples: Sequence[int],
    num_nerf_samples: int,
    train: bool,
    uniforms: Sequence[torch.Tensor] | None,
    anneal: float | torch.Tensor = 1.0,
    initial_spacing: str = "piecewise",
):
    """Hierarchical proposal sampling with ``w**anneal`` weight annealing
    (``anneal`` a float, or a 0-dim tensor on the weights' device).

    ``uniforms`` holds one draw per sampler stage (len(density_fns) + 1):
    the initial spaced sampler's, then each PDF resampling's. Returns
    (ray_samples, weights_list, ray_samples_list) for the proposal levels.
    Every stage's bins are spaced by ``initial_spacing``: "piecewise"
    (uniform up to distance 1, then linear in disparity) or "uniform"."""
    n_levels = len(density_fns)
    if len(num_proposal_samples) != n_levels:
        raise ValueError("one proposal sample count per density function")
    draws = list(uniforms) if uniforms is not None else [None] * (n_levels + 1)
    weights_list = []
    ray_samples_list = []
    with span("sampler.spaced"):
        samples = spaced_samples(
            bundle, num_proposal_samples[0], spacing=initial_spacing, train=train,
            uniforms=draws[0],
        )
    for i in range(n_levels):
        with span(f"proposal.{i}"):
            weights = samples.get_weights(density_fns[i](samples.positions()))
        with span(f"sampler.pdf.{i}"):
            # d/dw w**a is inf at w=0 for a<1: clamp inside the power only
            annealed = torch.pow(torch.clamp_min(weights, 1e-12), anneal)
            weights_list.append(weights)
            ray_samples_list.append(samples)
            num_next = num_proposal_samples[i + 1] if i + 1 < n_levels else num_nerf_samples
            new_bins = pdf_sample_bins(
                samples.spacing_bins(), annealed, num_next, train=train,
                uniforms=draws[i + 1],
            )
            samples = ray_samples_from_spacing_bins(bundle, new_bins, initial_spacing)
    return samples, weights_list, ray_samples_list
