"""Procedural synthetic fruit scenes, rendered without JAX at any size. Twin
of ``fruitnerf_tpu/data/synthetic.py``.

The scene itself (fruit and leaf spheres, the camera ring) and the numpy
ray tracer come from the JAX package's numpy-only module. Its
``render_scene`` traces on a JAX device above 2,000,000 ray-sphere pairs a
camera; this module's ``render_scene`` takes the same branch there, on a
torch device, through ``_device_camera_renderer``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from fruitnerf_tpu.data import synthetic as _np_synthetic
from fruitnerf_tpu.data.synthetic import (  # noqa: F401  (re-exported)
    SyntheticSceneConfig,
    fruit_centers,
    hemisphere_poses,
    leaf_centers,
    orchard_config,
)

NUMPY_MAX_PAIRS = 2_000_000  # ray-sphere pairs a camera the numpy tracer takes


def _light() -> np.ndarray:
    light = np.array([0.5, 0.3, 0.8])
    return light / np.linalg.norm(light)


def _device_camera_renderer(config, dirs_cam, centers, radii, colors, num_fruits, device):
    """Whole-camera renderer on ``device``: the twin of the JAX package's
    ``_device_camera_renderer``. Returns ``render_pose(pose [3,4]) ->
    (rgb uint8 [R,3], mask bool [R])``, tracing and shading in ray chunks
    that keep the [rays, spheres] temporaries near 100 MB.

    Every product is an elementwise float32 sum, never a matmul: the hit
    test's b*b - c cancels terms of about 5 down to r^2 ~ 1e-3, so a
    reduced-precision matmul (TF32) would turn fruit into speckle."""
    c = torch.as_tensor(centers, dtype=torch.float32, device=device)  # [K, 3]
    r_sq = torch.as_tensor(radii, dtype=torch.float32, device=device) ** 2
    col = torch.as_tensor(colors, dtype=torch.float32, device=device)
    dc = torch.as_tensor(dirs_cam, dtype=torch.float32, device=device)  # [R, 3]
    bg = torch.as_tensor(np.array(config.background, np.float32), device=device)
    light = torch.as_tensor(_light(), dtype=torch.float32, device=device)
    chunk = max(1 << 12, min(1 << 15, (25_000_000 // max(len(centers), 1)) & ~127))

    def dot3(a, b):  # [..., 3] x [..., 3] -> [...], in float32
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    @torch.inference_mode()
    def render_pose(pose):
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
        rot, eye = pose[:, :3], pose[:, 3]
        oc = eye[None, :] - c  # [K, 3]
        cc = dot3(oc, oc) - r_sq  # [K]
        rgbs, masks = [], []
        for start in range(0, dc.shape[0], chunk):
            d = dot3(dc[start : start + chunk, None, :], rot[None, :, :])  # [r, 3]
            b = dot3(d[:, None, :], oc[None, :, :])  # [r, K]
            disc = b * b - cc[None, :]
            t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
            t = torch.where((disc >= 0) & (t > 1e-4), t, torch.inf)
            tmin, idx = torch.min(t, dim=-1)
            hit = torch.isfinite(tmin)
            pts = eye[None, :] + d * torch.where(hit, tmin, 0.0)[:, None]
            normals = pts - c[idx]
            normals = normals / torch.clamp_min(torch.linalg.vector_norm(normals, dim=-1, keepdim=True), 1e-9)
            shade = 0.35 + 0.65 * torch.clamp_min(dot3(normals, light), 0.0)
            rgb = torch.where(hit[:, None], col[idx] * shade[:, None], bg[None, :])
            rgbs.append(torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8))
            masks.append(hit & (idx < num_fruits))
        return torch.cat(rgbs), torch.cat(masks)

    return render_pose


def _scene_geometry(config: SyntheticSceneConfig):
    """The scene's spheres and the camera's unit ray directions, as the JAX
    package's ``render_scene`` builds them."""
    h = w = config.image_size
    f = (w / 2.0) / np.tan(np.deg2rad(config.fov_deg) / 2.0)
    fruits = fruit_centers(config)
    leaves = leaf_centers(config)
    centers = np.concatenate([fruits, leaves], axis=0)
    radii = np.concatenate([
        np.full(len(fruits), config.fruit_radius),
        np.full(len(leaves), config.leaf_radius),
    ]).astype(np.float32)
    colors = np.concatenate([
        np.tile(np.array(config.fruit_color, np.float32), (len(fruits), 1)),
        np.tile(np.array(config.canopy_color, np.float32), (len(leaves), 1)),
    ])
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = (xs.ravel() + 0.5 - w / 2.0) / f
    py = -(ys.ravel() + 0.5 - h / 2.0) / f
    dirs_cam = np.stack([px, py, -np.ones_like(px)], axis=-1)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    return f, fruits, centers, radii, colors, dirs_cam


def numpy_fruit_mask(config: SyntheticSceneConfig, pose) -> np.ndarray:
    """One camera's fruit mask [H, W] bool from the JAX package's numpy ray
    tracer: the reference the torch renderer is held to."""
    _, _, centers, radii, _, dirs_cam = _scene_geometry(config)
    pose = np.asarray(pose, np.float32)
    dirs = dirs_cam.astype(np.float32) @ pose[:3, :3].T
    origins = np.broadcast_to(pose[:3, 3], dirs.shape).copy()
    t, idx = _np_synthetic._ray_sphere_hits(origins, dirs, centers, radii)
    mask = np.isfinite(t) & (idx < config.num_fruits)
    return mask.reshape(config.image_size, config.image_size)


def ray_sphere_pairs(config: SyntheticSceneConfig) -> int:
    """Ray-sphere pairs a camera: the quantity the renderer branches on."""
    return config.image_size**2 * (config.num_fruits + len(leaf_centers(config)))


def render_scene(config: SyntheticSceneConfig, device=None) -> dict:
    """Render every camera analytically: the JAX package's numpy tracer at or
    below ``NUMPY_MAX_PAIRS`` ray-sphere pairs a camera, the torch renderer on
    ``device`` (default: the GPU if there is one) above it, as the JAX
    package's branch rule. Returns its dict: images [N,H,W,3] and masks
    [N,H,W] float32, poses [N,3,4], intrinsics, fruit centers [K,3]."""
    if ray_sphere_pairs(config) <= NUMPY_MAX_PAIRS:
        return _np_synthetic.render_scene(config)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    h = w = config.image_size
    f, fruits, centers, radii, colors, dirs_cam = _scene_geometry(config)
    poses = hemisphere_poses(config)
    render_pose = _device_camera_renderer(
        config, dirs_cam.astype(np.float32), centers, radii, colors.astype(np.float32),
        len(fruits), device,
    )
    images, masks = [], []
    for pose in poses:
        rgb_u8, mask = render_pose(pose)
        images.append(rgb_u8.cpu().numpy().astype(np.float32).reshape(h, w, 3) / 255.0)
        masks.append(mask.cpu().numpy().astype(np.float32).reshape(h, w))
    return {
        "images": np.stack(images),
        "masks": np.stack(masks),
        "poses": poses,
        "fx": f,
        "fy": f,
        "cx": w / 2.0,
        "cy": h / 2.0,
        "width": w,
        "height": h,
        "fruit_centers": fruits,
        "fruit_radius": config.fruit_radius,
    }


def scene_cache_key(config: SyntheticSceneConfig) -> str:
    """The scene config's cache key. Sequence fields are normalised to
    tuples of floats first, so a list and a tuple of the same values (for
    example ``camera_elevation``) give one key."""
    items = {
        k: tuple(float(e) for e in v) if isinstance(v, (list, tuple)) else v
        for k, v in dataclasses.asdict(config).items()
    }
    return hashlib.sha1(repr(sorted(items.items())).encode()).hexdigest()[:16]


def scene_cache_path(config: SyntheticSceneConfig, cache_dir=None) -> Path:
    """The scene's cache file: ``scene_torch_v1_<key>.npz``, apart from the
    JAX package's, in ``<repo>/.scene_cache`` by default."""
    if cache_dir is None:
        cache_dir = Path(__file__).resolve().parents[2] / ".scene_cache"
    return Path(cache_dir) / f"scene_torch_v1_{scene_cache_key(config)}.npz"


def cached_render_scene(config: SyntheticSceneConfig, cache_dir=None, device=None) -> dict:
    """``render_scene`` with an npz disk cache at ``scene_cache_path``;
    images and masks are stored as uint8 when that round-trips exactly."""
    path = scene_cache_path(config, cache_dir)
    cache_dir = path.parent
    if path.exists():
        with np.load(path) as z:
            out = {k: z[k] if z[k].shape else z[k].item() for k in z.files}
        for k in ("images", "masks"):
            if out[k].dtype == np.uint8:
                out[k] = out[k].astype(np.float32) / 255.0
        return out
    scene = render_scene(config, device)
    cache_dir.mkdir(parents=True, exist_ok=True)
    packed = dict(scene)
    for k in ("images", "masks"):
        u8 = np.round(scene[k] * 255.0).astype(np.uint8)
        if np.array_equal(u8.astype(np.float32) / 255.0, scene[k]):
            packed[k] = u8
    tmp = path.with_suffix(f".tmp{os.getpid()}.npz")  # rename is the atomic step
    np.savez_compressed(tmp, **packed)
    tmp.replace(path)
    return scene
