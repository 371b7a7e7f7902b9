"""Procedural synthetic fruit scenes, rendered without JAX at any size. Twin
of ``fruitnerf_tpu/data/synthetic.py``.

The scene (fruit and leaf spheres, the camera ring) and the numpy ray
tracer are the port's copy of the JAX package's numpy code. Its
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

from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticSceneConfig:
    num_fruits: int = 6
    fruit_radius: float = 0.08
    canopy_radius: float = 0.45  # fruits scattered inside this sphere
    num_cameras: int = 20
    image_size: int = 64
    camera_distance: float = 2.2
    fov_deg: float = 55.0
    seed: int = 0
    background: tuple = (1.0, 1.0, 1.0)
    fruit_color: tuple = (0.85, 0.15, 0.1)
    canopy_color: tuple = (0.15, 0.45, 0.12)
    num_leaves: int = 30
    leaf_radius: float = 0.06
    # 0 = fruits anywhere in the canopy ball; f in (0,1) = fruits only in the
    # outer shell radius in [f, 1] x canopy_radius. Real fruit hangs on the
    # outer canopy; a solid uniform fill buries most fruits behind ~8 optical
    # depths of foliage, making them unobservable by ANY capture — the
    # reference's Blender trees keep fruit visible enough for mask-driven
    # counting (config_synthetic.py GT counts with F1 ~0.9).
    fruit_shell_fraction: float = 0.0
    # (lo, hi) camera elevation range in radians. The default upper-ring rig
    # never views the crown from below; the reference's captures circle the
    # tree at fruit height and below (README.md capture protocol), so this
    # knob lets dense-scene runs widen to ~(-0.2, 0.8). Round-5 analytic
    # visibility probe on plum-781: fruits with <3 occluder-free center views
    # drop 137 -> 108 when widened — a modest gain, because the dominant FN
    # cause is fruits whose center sits INSIDE a leaf sphere (107/781 at plum
    # density; no rig can see those centers, only their protruding crescent).
    # Kept at the historic default so every committed scene cache / report
    # stays bit-identical unless explicitly overridden.
    camera_elevation: tuple = (0.25, 0.80)


def orchard_config(
    num_fruits: int = 283, num_cameras: int = 120, image_size: int = 512,
    seed: int = 7, camera_elevation: tuple | None = None,
) -> SyntheticSceneConfig:
    """Reference-scale scene: the apple-orchard shape of the reference's
    synthetic evaluation (283 fruits from ~300 cams at 1024^2,
    clustering/config_synthetic.py:14). Fruit radius shrinks with count so
    rejection sampling stays feasible in the canopy sphere.

    Occlusion is held CONSTANT across fruit counts: fruit-fruit packing is
    scale-invariant by construction (total fruit volume ~ N * r^3 is fixed
    by the radius rule), and the leaf budget keeps total leaf cross-section
    N_l * (1.3 r)^2 at the 283-scene value rather than growing ~ N. The old
    ``max(200, num_fruits)`` rule made the plum-781 canopy ~40% more
    occluding than apple-283 purely as a generator artifact (102/781 fruits
    invisible to every camera, round-4 plum post-mortem); the reference's
    Blender trees do not scale foliage with fruit count. The budget only
    CAPS the old rule, so every scene with <= 283 fruits (every committed
    headline/sparse/bench scene) is bit-identical to before."""
    radius = min(0.04, 0.45 / (2.0 * num_fruits ** (1.0 / 3.0)))
    # leaf cross-section budget of the 283 scene: 283 * (1.3 * r_283)^2
    r_283 = 0.45 / (2.0 * 283 ** (1.0 / 3.0))
    leaf_budget = 283.0 * (1.3 * r_283) ** 2
    num_leaves = max(
        200, min(num_fruits, round(leaf_budget / (1.3 * radius) ** 2))
    )
    kw = {}
    if camera_elevation is not None:
        kw["camera_elevation"] = tuple(float(e) for e in camera_elevation)
    return SyntheticSceneConfig(
        num_fruits=num_fruits,
        fruit_radius=float(radius),
        num_cameras=num_cameras,
        image_size=image_size,
        num_leaves=num_leaves,
        leaf_radius=float(radius * 1.3),
        fruit_shell_fraction=0.62,
        seed=seed,
        **kw,
    )


def fruit_centers(config: SyntheticSceneConfig) -> np.ndarray:
    """[K, 3] fruit centers, min-separation enforced (rejection sampling)."""
    rng = np.random.RandomState(config.seed)
    centers = []
    min_sep = 2.6 * config.fruit_radius
    r_lo = config.fruit_shell_fraction * config.canopy_radius
    while len(centers) < config.num_fruits:
        c = rng.uniform(-config.canopy_radius, config.canopy_radius, 3)
        r = np.linalg.norm(c)
        if r > config.canopy_radius or r < r_lo:
            continue
        if centers and np.min(
            np.linalg.norm(np.array(centers) - c, axis=-1)
        ) < min_sep:
            continue
        centers.append(c)
    return np.array(centers, np.float32)


def leaf_centers(config: SyntheticSceneConfig) -> np.ndarray:
    rng = np.random.RandomState(config.seed + 1)
    pts = rng.uniform(-config.canopy_radius, config.canopy_radius, (config.num_leaves * 3, 3))
    pts = pts[np.linalg.norm(pts, axis=-1) < config.canopy_radius][: config.num_leaves]
    return pts.astype(np.float32)


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-convention camera-to-world [3,4] (camera -z looks at target)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.stack([right, true_up, -forward], axis=-1)  # columns: x, y, z(back)
    return np.concatenate([c2w, eye[:, None]], axis=-1).astype(np.float32)


def hemisphere_poses(config: SyntheticSceneConfig) -> np.ndarray:
    """[N, 3, 4] cameras on an upper hemisphere looking at the origin."""
    n = config.num_cameras
    golden = np.pi * (3.0 - np.sqrt(5.0))
    lo, hi = config.camera_elevation
    poses = []
    for i in range(n):
        elev = lo + (hi - lo) * (i / max(n - 1, 1))  # elevation sweep (rad)
        az = golden * i
        eye = config.camera_distance * np.array(
            [np.cos(az) * np.cos(elev), np.sin(az) * np.cos(elev), np.sin(elev)]
        )
        poses.append(look_at_pose(eye, np.zeros(3)))
    return np.stack(poses)


def _ray_sphere_hits(origins, dirs, centers, radii):
    """Nearest-hit t per ray over a set of spheres.

    origins [R,3], dirs [R,3] unit, centers [K,3], radii [K]
    -> (t [R], idx [R]) with t=inf where no hit.
    """
    oc = origins[:, None, :] - centers[None, :, :]  # [R,K,3]
    b = np.einsum("rkj,rj->rk", oc, dirs)
    c = np.einsum("rkj,rkj->rk", oc, oc) - radii[None, :] ** 2
    disc = b * b - c
    hit = disc >= 0
    sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
    t = -b - sqrt_disc
    t = np.where(hit & (t > 1e-4), t, np.inf)
    idx = np.argmin(t, axis=-1)
    tmin = t[np.arange(t.shape[0]), idx]
    return tmin, idx



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
    """One camera's fruit mask [H, W] bool from the numpy ray tracer: the
    reference the torch renderer is held to."""
    _, _, centers, radii, _, dirs_cam = _scene_geometry(config)
    pose = np.asarray(pose, np.float32)
    dirs = dirs_cam.astype(np.float32) @ pose[:3, :3].T
    origins = np.broadcast_to(pose[:3, 3], dirs.shape).copy()
    t, idx = _ray_sphere_hits(origins, dirs, centers, radii)
    mask = np.isfinite(t) & (idx < config.num_fruits)
    return mask.reshape(config.image_size, config.image_size)


def ray_sphere_pairs(config: SyntheticSceneConfig) -> int:
    """Ray-sphere pairs a camera: the quantity the renderer branches on."""
    return config.image_size**2 * (config.num_fruits + len(leaf_centers(config)))


def _numpy_camera_renderer(config, dirs_cam, centers, radii, colors, num_fruits):
    """The JAX package's numpy tracer and Lambertian shading, one camera at a
    time: ``render_pose(pose [3,4]) -> (rgb float32 [R,3], mask float32 [R])``."""
    light = _light()
    background = np.array(config.background, np.float32)

    def render_pose(pose):
        rot, eye = pose[:3, :3], pose[:3, 3]
        dirs = dirs_cam @ rot.T
        origins = np.ascontiguousarray(np.broadcast_to(eye, dirs.shape))
        t, idx = _ray_sphere_hits(origins, dirs, centers, radii)
        hit = np.isfinite(t)
        img = np.tile(background, (dirs.shape[0], 1))
        pts = origins + dirs * np.where(hit, t, 0.0)[:, None]
        normals = pts - centers[idx]
        normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
        shade = 0.35 + 0.65 * np.maximum(normals @ light, 0.0)
        img[hit] = colors[idx[hit]] * shade[hit, None]
        return img, (hit & (idx < num_fruits)).astype(np.float32)

    return render_pose


def render_scene(config: SyntheticSceneConfig, device="cuda") -> dict:
    """Render every camera analytically: the numpy tracer at or below
    ``NUMPY_MAX_PAIRS`` ray-sphere pairs a camera, the torch renderer on
    ``device`` (the card unless the caller names the CPU) above it, as the
    JAX package's branch rule. Returns its dict: images [N,H,W,3] and masks
    [N,H,W] float32, poses [N,3,4], intrinsics, fruit centers [K,3]."""
    h = w = config.image_size
    f, fruits, centers, radii, colors, dirs_cam = _scene_geometry(config)
    poses = hemisphere_poses(config)
    if ray_sphere_pairs(config) <= NUMPY_MAX_PAIRS:
        render_pose = _numpy_camera_renderer(config, dirs_cam, centers, radii, colors,
                                             len(fruits))
    else:
        torch_render = _device_camera_renderer(
            config, dirs_cam.astype(np.float32), centers, radii, colors.astype(np.float32),
            len(fruits), resolve_device(device),
        )

        def render_pose(pose):
            rgb_u8, mask = torch_render(pose)
            return (rgb_u8.cpu().numpy().astype(np.float32) / 255.0,
                    mask.cpu().numpy().astype(np.float32))
    images, masks = [], []
    for pose in poses:
        rgb, mask = render_pose(pose)
        images.append(rgb.reshape(h, w, 3))
        masks.append(mask.reshape(h, w))
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


def cached_render_scene(config: SyntheticSceneConfig, cache_dir=None, device="cuda") -> dict:
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
