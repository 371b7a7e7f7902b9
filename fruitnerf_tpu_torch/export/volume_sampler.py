"""Volume export: probe the trained field on a uniform N^3 grid and keep the
fruit points as three ``.ply`` clouds. Twin of
``fruitnerf_tpu/export/volume_sampler.py``.

  * An N x N grid of orthographic rays on the AABB's min-z face, along +z,
    near 0 and far the box's extent; N uniform samples a ray give N^3
    probes.
  * Each batch runs the export forward (no compositing): positions, rgb,
    the semantic logit and its sigmoid, density.
  * Three masks: ``semantic`` (logit >= 3 and density >= 70),
    ``semantic_colormap`` (sigmoid >= 0.9 and density >= 70; the
    reference's effective colormap mask, a superset of ``semantic``) and
    ``density`` (density >= 70).
  * Points are un-normalized by x 2 / dataparser_scale: training contracts
    positions by (x + 2) / 4, export normalizes the +-1 box by (x + 1) / 2,
    so the field trained at x' answers at x'/2. The counting profiles'
    lengths are calibrated in the space this gives.

Each batch is masked on the device, and only the surviving rows cross to
the host, in one copy a batch. With ``devices`` each batch's rays are split
over the devices by the twin's stride permutation (``sample_volume(mesh=)``,
``_export_batch_sharded``): every device queries and masks its shard with
its own copy of the parameters, and the shards' rows are concatenated in
shard order. The mask keeps every surviving point: the
JAX twin's fixed-capacity compaction, which drops points past
``compaction_fraction`` of a batch, is a TPU formulation and is not ported,
so ``overflowed`` is always 0.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..bridge import tree_map
from ..core.rays import RayBundle
from ..models.fruit_model import FruitModelConfig, forward_export
from .ply import write_ply

CLOUDS = ("semantic", "semantic_colormap", "density")
MAX_PROBES = 1 << 22  # probes a batch


@dataclasses.dataclass(frozen=True)
class ExportConfig:
    """The reference exporter's flags, as the JAX twin's ExportConfig."""

    bounding_box_min: tuple = (-1.0, -1.0, -1.0)
    bounding_box_max: tuple = (1.0, 1.0, 1.0)
    num_points_per_side: int = 1000
    num_rays_per_batch: int = 32768
    semantic_logit_threshold: float = 3.0
    density_threshold: float = 70.0
    # the reference compares a heaviside(sigmoid - 0.9) label against 0.999,
    # so its effective threshold on the raw sigmoid is 0.9
    colormap_prob_threshold: float = 0.9

    @property
    def aabb(self) -> np.ndarray:
        return np.array([self.bounding_box_min, self.bounding_box_max], np.float32)


def orthographic_ray_grid(aabb: np.ndarray, n: int, axis: int = 2):
    """[n*n, 3] ray origins on the min face orthogonal to ``axis``, the
    shared direction, and the far plane."""
    lo, hi = aabb[0], aabb[1]
    axes = [a for a in range(3) if a != axis]
    u = np.linspace(lo[axes[0]], hi[axes[0]], n, dtype=np.float32)
    v = np.linspace(lo[axes[1]], hi[axes[1]], n, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    origins = np.zeros((n * n, 3), np.float32)
    origins[:, axes[0]] = uu.ravel()
    origins[:, axes[1]] = vv.ravel()
    origins[:, axis] = lo[axis]
    direction = np.zeros(3, np.float32)
    direction[axis] = 1.0
    far = float(hi[axis] - lo[axis])
    return origins, direction, far


def export_masks(logit, prob, density, thresholds) -> dict[str, torch.Tensor]:
    """The three survival masks; thresholds = (semantic logit, density,
    colormap sigmoid)."""
    dens_m = density >= thresholds[1]
    return {
        "semantic": (logit >= thresholds[0]) & dens_m,
        "semantic_colormap": (prob >= thresholds[2]) & dens_m,
        "density": dens_m,
    }


def rays_per_batch(export_config: ExportConfig, num_shards: int = 1) -> int:
    """Rays a batch: the configured batch, capped so that a shard holds at
    most ``MAX_PROBES`` probes (at least 1024 rays), then cut to a multiple
    of the shards, as the JAX twin."""
    n = export_config.num_points_per_side
    batch = min(export_config.num_rays_per_batch, max(1024, MAX_PROBES * num_shards // n))
    return max(num_shards, batch - batch % num_shards)


def probe_bundle(origins: torch.Tensor, direction: torch.Tensor, far: float) -> RayBundle:
    """A batch of orthographic rays: ``origins`` [r, 3] along ``direction``
    [3], near 0 and far ``far``, camera 0 (export uses the mean appearance)."""
    r, dev = origins.shape[0], origins.device
    return RayBundle(
        origins=origins,
        directions=direction.expand(r, 3),
        nears=torch.zeros((r,), device=dev),
        fars=torch.full((r,), far, device=dev),
        camera_indices=torch.zeros((r,), dtype=torch.int64, device=dev),
    )


def _surviving_rows(out: dict, thresholds) -> torch.Tensor:
    """A batch's ``forward_export`` outputs masked on their device: the
    surviving rows [M, 7 + 3] (position, rgb, sigmoid, the three masks)."""
    prob = out["semantics_prob"].reshape(-1)
    masks = export_masks(
        out["semantics"].reshape(-1), prob, out["density"].reshape(-1), thresholds
    )
    bits = torch.stack([masks[k] for k in CLOUDS], dim=-1)  # [P, 3]
    keep = torch.nonzero(bits.any(dim=-1)).squeeze(1)
    return torch.cat([
        out["positions"].reshape(-1, 3)[keep],
        out["rgb"].reshape(-1, 3)[keep],
        prob[keep, None],
        bits[keep].float(),
    ], dim=-1)


def sample_volume(
    params,
    model_config: FruitModelConfig,
    export_config: ExportConfig,
    dataparser_scale: float,
    output_dir,
    scene_aabb=None,  # [2,3] field-normalization box; defaults to +-1
    progress: bool = True,
    devices=None,
) -> dict:
    """Stream the N^3 probe grid through the field (``params``: the model's
    parameters, on the device to run on) and write the three ``.ply``
    clouds. Returns {name: {"points", "colors", "path", "overflowed"}}.

    With ``devices`` (a list) shard i of every batch, rays i, i + G, ...
    of its G shards (the twin's ``shard_perm``, which gives every shard a
    uniform subsample of the face), runs on ``devices[i]``."""
    dev = params["field"]["base_mlp"]["w0"].device
    shards = [dev] if devices is None else [torch.device(d) for d in devices]
    n = export_config.num_points_per_side
    origins_np, direction_np, far = orthographic_ray_grid(export_config.aabb, n)
    batch = rays_per_batch(export_config, len(shards))
    if scene_aabb is None:
        scene_aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    aabb = np.asarray(scene_aabb, np.float32)
    thresholds = (export_config.semantic_logit_threshold, export_config.density_threshold,
                  export_config.colormap_prob_threshold)
    # each shard's device: the parameters, the rays, the direction and box
    place = [(params if d == dev else tree_map(params, lambda t, d=d: t.to(d)),
              torch.from_numpy(origins_np).to(d), torch.from_numpy(direction_np).to(d),
              torch.as_tensor(aabb, device=d)) for d in shards]
    g = len(shards)

    parts = []  # per batch and shard: surviving rows [M, 7 + 3] on the host
    total = origins_np.shape[0]
    with torch.inference_mode():
        for start in range(0, total, batch):
            # every shard's forward is queued before the first mask waits on
            # its device, so that shards on distinct cards overlap
            outs = [forward_export(p, probe_bundle(o[start : start + batch][i::g], d, far),
                                   model_config, n, a)
                    for i, (p, o, d, a) in enumerate(place)]
            # each shard's one copy to the host
            parts.extend(_surviving_rows(out, thresholds).cpu().numpy() for out in outs)
            if progress:
                done = min(start + batch, total)
                print(f"export: {done}/{total} rays ({done * n / 1e6:.1f}M probes)", flush=True)

    rows = np.concatenate(parts) if parts else np.zeros((0, 7 + len(CLOUDS)), np.float32)
    unscale = (1.0 / dataparser_scale) * 2.0
    output_dir = Path(output_dir)
    result = {}
    for i, name in enumerate(CLOUDS):
        sel = rows[:, 7 + i] > 0.5
        pts = rows[sel, :3] * unscale
        cols = rows[sel, 3:7]
        path = write_ply(output_dir / f"{name}.ply", pts, cols)
        result[name] = {"points": pts, "colors": cols, "path": path, "overflowed": 0}
    return result
