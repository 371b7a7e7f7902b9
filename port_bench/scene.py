"""The benchmark's input scenes: procedural orchards rendered on the card.

Frozen copy of ``fruitnerf_tpu_torch/data/synthetic.py`` (``orchard_config``,
``fruit_centers``, ``leaf_centers``, ``look_at_pose``, ``hemisphere_poses``,
``_scene_geometry`` and the torch renderer ``_device_camera_renderer``) as
of the benchmark's first version. Unlike the port's ``render_scene`` it
always renders on the given device and returns uint8 images and 0/1 uint8
masks, which the port's ``build_device_dataset`` takes as they are.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULTS = dict(fruit_radius=0.08, canopy_radius=0.45, camera_distance=2.2, fov_deg=55.0,
                background=(1.0, 1.0, 1.0), fruit_color=(0.85, 0.15, 0.1),
                canopy_color=(0.15, 0.45, 0.12), fruit_shell_fraction=0.0,
                camera_elevation=(0.25, 0.80))


def orchard(num_fruits: int, num_cameras: int, image_size: int, seed: int) -> dict:
    """The reference-scale orchard's parameters (``orchard_config``): the
    fruit radius shrinks with the count, the leaf budget is held at the
    283-fruit scene's cross-section."""
    radius = min(0.04, 0.45 / (2.0 * num_fruits ** (1.0 / 3.0)))
    r_283 = 0.45 / (2.0 * 283 ** (1.0 / 3.0))
    leaf_budget = 283.0 * (1.3 * r_283) ** 2
    num_leaves = max(200, min(num_fruits, round(leaf_budget / (1.3 * radius) ** 2)))
    return {**DEFAULTS, "num_fruits": num_fruits, "fruit_radius": float(radius),
            "num_cameras": num_cameras, "image_size": image_size, "num_leaves": num_leaves,
            "leaf_radius": float(radius * 1.3), "fruit_shell_fraction": 0.62,
            "seed": int(seed) % (1 << 32)}


def fruit_centers(c: dict) -> np.ndarray:
    rng = np.random.RandomState(c["seed"])
    centers = []
    min_sep = 2.6 * c["fruit_radius"]
    r_lo = c["fruit_shell_fraction"] * c["canopy_radius"]
    while len(centers) < c["num_fruits"]:
        p = rng.uniform(-c["canopy_radius"], c["canopy_radius"], 3)
        r = np.linalg.norm(p)
        if r > c["canopy_radius"] or r < r_lo:
            continue
        if centers and np.min(np.linalg.norm(np.array(centers) - p, axis=-1)) < min_sep:
            continue
        centers.append(p)
    return np.array(centers, np.float32)


def leaf_centers(c: dict) -> np.ndarray:
    rng = np.random.RandomState((c["seed"] + 1) % (1 << 32))
    pts = rng.uniform(-c["canopy_radius"], c["canopy_radius"], (c["num_leaves"] * 3, 3))
    pts = pts[np.linalg.norm(pts, axis=-1) < c["canopy_radius"]][: c["num_leaves"]]
    return pts.astype(np.float32)


def look_at_pose(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.stack([right, true_up, -forward], axis=-1)
    return np.concatenate([c2w, eye[:, None]], axis=-1).astype(np.float32)


def hemisphere_poses(c: dict) -> np.ndarray:
    n = c["num_cameras"]
    golden = np.pi * (3.0 - np.sqrt(5.0))
    lo, hi = c["camera_elevation"]
    poses = []
    for i in range(n):
        elev = lo + (hi - lo) * (i / max(n - 1, 1))
        az = golden * i
        eye = c["camera_distance"] * np.array(
            [np.cos(az) * np.cos(elev), np.sin(az) * np.cos(elev), np.sin(elev)])
        poses.append(look_at_pose(eye, np.zeros(3)))
    return np.stack(poses)


def render(c: dict, device) -> dict:
    """Every camera of the orchard, traced on ``device`` in ray chunks:
    the scene dict the port's ``dataset_from_scene`` takes (images [N,H,W,3]
    and masks [N,H,W] uint8, poses, intrinsics, fruit centres)."""
    h = w = c["image_size"]
    f = (w / 2.0) / np.tan(np.deg2rad(c["fov_deg"]) / 2.0)
    fruits, leaves = fruit_centers(c), leaf_centers(c)
    centers = np.concatenate([fruits, leaves], axis=0)
    radii = np.concatenate([np.full(len(fruits), c["fruit_radius"]),
                            np.full(len(leaves), c["leaf_radius"])]).astype(np.float32)
    colors = np.concatenate([np.tile(np.array(c["fruit_color"], np.float32), (len(fruits), 1)),
                             np.tile(np.array(c["canopy_color"], np.float32), (len(leaves), 1))])
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = (xs.ravel() + 0.5 - w / 2.0) / f
    py = -(ys.ravel() + 0.5 - h / 2.0) / f
    dirs_cam = np.stack([px, py, -np.ones_like(px)], axis=-1)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    poses = hemisphere_poses(c)

    cen = torch.as_tensor(centers, dtype=torch.float32, device=device)
    r_sq = torch.as_tensor(radii, dtype=torch.float32, device=device) ** 2
    col = torch.as_tensor(colors, dtype=torch.float32, device=device)
    dc = torch.as_tensor(dirs_cam.astype(np.float32), device=device)
    bg = torch.as_tensor(np.array(c["background"], np.float32), device=device)
    light = np.array([0.5, 0.3, 0.8])
    light = torch.as_tensor(light / np.linalg.norm(light), dtype=torch.float32, device=device)
    chunk = max(1 << 12, min(1 << 15, (25_000_000 // max(len(centers), 1)) & ~127))
    nf = len(fruits)

    def dot3(a, b):  # elementwise float32 sums, never a reduced-precision matmul
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    images, masks = [], []
    with torch.inference_mode():
        for pose in poses:
            pose_t = torch.as_tensor(pose, device=device)
            rot, eye = pose_t[:, :3], pose_t[:, 3]
            oc = eye[None, :] - cen
            cc = dot3(oc, oc) - r_sq
            rgbs, ms = [], []
            for start in range(0, dc.shape[0], chunk):
                d = dot3(dc[start : start + chunk, None, :], rot[None, :, :])
                b = dot3(d[:, None, :], oc[None, :, :])
                disc = b * b - cc[None, :]
                t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
                t = torch.where((disc >= 0) & (t > 1e-4), t, torch.inf)
                tmin, idx = torch.min(t, dim=-1)
                hit = torch.isfinite(tmin)
                pts = eye[None, :] + d * torch.where(hit, tmin, 0.0)[:, None]
                nrm = pts - cen[idx]
                nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True),
                                            1e-9)
                shade = 0.35 + 0.65 * torch.clamp_min(dot3(nrm, light), 0.0)
                rgb = torch.where(hit[:, None], col[idx] * shade[:, None], bg[None, :])
                rgbs.append(torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8))
                ms.append((hit & (idx < nf)).to(torch.uint8))
            images.append(torch.cat(rgbs).reshape(h, w, 3))
            masks.append(torch.cat(ms).reshape(h, w))
        images_np = torch.stack(images).cpu().numpy()
        masks_np = torch.stack(masks).cpu().numpy()
    return {"images": images_np, "masks": masks_np, "poses": poses, "fx": f, "fy": f,
            "cx": w / 2.0, "cy": h / 2.0, "width": w, "height": h, "fruit_centers": fruits,
            "fruit_radius": c["fruit_radius"]}
