"""The port's scene renderer (fruitnerf_tpu_torch/data/synthetic.py): the
torch camera renderer against the JAX package's device renderer on the CPU,
the numpy/torch branch rule of ``render_scene``, the scene cache key, and
the port's copy of the scene and its numpy tracer against the JAX
package's."""
import dataclasses

import jax.numpy as jnp  # noqa: F401  (the JAX renderer runs on this process's CPU backend)
import numpy as np
import pytest
import torch

from fruitnerf_tpu.data import synthetic as jsyn
from fruitnerf_tpu_torch.data import synthetic as syn

MAX_MASK_FLIPS = 2e-3  # share of pixels whose fruit mask differs
RGB_ATOL = 1  # uint8 levels, where the masks agree


def _flips_and_rgb(config, poses):
    _, fruits, centers, radii, colors, dirs_cam = syn._scene_geometry(config)
    args = (config, dirs_cam.astype(np.float32), centers, radii, colors.astype(np.float32),
            len(fruits))
    jrender = jsyn._device_camera_renderer(*args)
    trender = syn._device_camera_renderer(*args, "cpu")
    for pose in poses:
        jrgb, jmask = (np.asarray(a) for a in jrender(pose.astype(np.float32)))
        trgb, tmask = (a.numpy() for a in trender(pose))
        yield jrgb, jmask, trgb, tmask


def test_torch_renderer_matches_jax_renderer():
    """48^2, 3 poses, 40 spheres (10 fruits, 30 leaves)."""
    config = jsyn.SyntheticSceneConfig(num_fruits=10, num_leaves=30, image_size=48, num_cameras=3)
    poses = jsyn.hemisphere_poses(config)
    assert len(jsyn.leaf_centers(config)) == 30
    for jrgb, jmask, trgb, tmask in _flips_and_rgb(config, poses):
        assert trgb.dtype == np.uint8 and trgb.shape == jrgb.shape == (48 * 48, 3)
        assert jmask.any()  # the view shows fruit
        agree = tmask == jmask
        assert 1.0 - agree.mean() <= MAX_MASK_FLIPS
        diff = np.abs(trgb.astype(np.int32) - jrgb.astype(np.int32)).max(-1)
        assert diff[agree].max() <= RGB_ATOL


def test_render_scene_branches_at_two_million_pairs(monkeypatch):
    """At most 2M ray-sphere pairs a camera: the JAX package's numpy tracer,
    bit for bit. Above: the torch renderer, whose scene matches the numpy
    tracer's up to edge pixels."""
    calls = []
    real = syn._device_camera_renderer

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(syn, "_device_camera_renderer", spy)
    small = jsyn.SyntheticSceneConfig(num_fruits=6, num_leaves=30, image_size=32, num_cameras=2)
    assert syn.ray_sphere_pairs(small) <= syn.NUMPY_MAX_PAIRS
    got, want = syn.render_scene(small), jsyn.render_scene(small)
    assert calls == []
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)

    # 64^2 x 506 spheres = 2.07M pairs a camera
    big = dataclasses.replace(small, num_leaves=500, image_size=64, leaf_radius=0.02)
    assert syn.ray_sphere_pairs(big) > syn.NUMPY_MAX_PAIRS
    got = syn.render_scene(big, device="cpu")
    assert calls == [torch.device("cpu")]
    monkeypatch.setattr(syn, "NUMPY_MAX_PAIRS", 10**9)  # the numpy tracer as the reference
    want = syn.render_scene(big)
    assert set(got) == set(want)
    for k in ("poses", "fruit_centers", "fx", "cx", "width", "fruit_radius"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["images"].dtype == np.float32 and got["images"].shape == (2, 64, 64, 3)
    assert float(np.mean(got["masks"] != want["masks"])) <= MAX_MASK_FLIPS
    agree = np.broadcast_to((got["masks"] == want["masks"])[..., None], got["images"].shape)
    assert np.abs(got["images"] - want["images"])[agree].max() <= RGB_ATOL / 255.0 + 1e-6


def test_cache_key_ignores_list_or_tuple(tmp_path, monkeypatch):
    """A list and a tuple ``camera_elevation`` give one key, so the second
    call reads the first's file (named apart from the JAX package's)."""
    as_tuple = jsyn.orchard_config(num_fruits=4, num_cameras=2, image_size=16,
                                   camera_elevation=(0.1, 0.7))
    as_list = dataclasses.replace(as_tuple, camera_elevation=[0.1, 0.7])
    assert syn.scene_cache_key(as_tuple) == syn.scene_cache_key(as_list)
    assert syn.scene_cache_key(as_tuple) != syn.scene_cache_key(
        dataclasses.replace(as_tuple, camera_elevation=(0.1, 0.8)))
    first = syn.cached_render_scene(as_tuple, cache_dir=tmp_path)
    [path] = tmp_path.iterdir()
    assert path.name == f"scene_torch_v1_{syn.scene_cache_key(as_tuple)}.npz"
    assert path == syn.scene_cache_path(as_list, cache_dir=tmp_path)

    def no_render(*args, **kwargs):
        raise AssertionError("rendered despite the cache")

    monkeypatch.setattr(syn, "render_scene", no_render)
    second = syn.cached_render_scene(as_list, cache_dir=tmp_path)
    for k in first:
        np.testing.assert_array_equal(np.asarray(second[k]), np.asarray(first[k]), err_msg=k)


def test_numpy_fruit_mask_is_the_numpy_tracers():
    """The one-camera reference mask equals the numpy tracer's scene masks."""
    config = jsyn.SyntheticSceneConfig(num_fruits=8, num_leaves=30, image_size=32, num_cameras=3)
    want = jsyn.render_scene(config)
    for pose, mask in zip(want["poses"], want["masks"]):
        got = syn.numpy_fruit_mask(config, pose)
        assert got.dtype == np.bool_ and got.any()
        np.testing.assert_array_equal(got, mask > 0.5)


@pytest.mark.parametrize("name", ["orchard_config", "SyntheticSceneConfig", "fruit_centers"])
def test_scene_definition_is_the_jax_packages(name):
    """The port's copy defines the same scene: the same config fields and
    defaults, the same orchard sizing, the same fruit and leaf centers and
    camera ring."""
    assert getattr(syn, name) is not getattr(jsyn, name)  # a copy, not an import
    for kw in ({}, {"num_fruits": 120, "num_cameras": 5, "image_size": 32},
               {"num_fruits": 781, "camera_elevation": [-0.2, 0.8]}):
        want = jsyn.orchard_config(**kw)
        got = syn.orchard_config(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for fn in ("fruit_centers", "leaf_centers", "hemisphere_poses"):
            np.testing.assert_array_equal(getattr(syn, fn)(got), getattr(jsyn, fn)(want),
                                          err_msg=fn)
    assert dataclasses.asdict(syn.SyntheticSceneConfig()) == dataclasses.asdict(
        jsyn.SyntheticSceneConfig())


@pytest.mark.parametrize("kw", [{}, {"num_fruits": 10, "num_leaves": 40, "image_size": 40,
                                     "num_cameras": 3, "seed": 5,
                                     "camera_elevation": (-0.2, 0.8)}])
def test_numpy_render_scene_equals_the_jax_packages(kw):
    """The copied numpy tracer renders the JAX package's images, masks and
    poses bit for bit."""
    cfg = dataclasses.replace(syn.SyntheticSceneConfig(image_size=24, num_cameras=2), **kw)
    assert syn.ray_sphere_pairs(cfg) <= syn.NUMPY_MAX_PAIRS
    got = syn.render_scene(cfg, device="cpu")
    want = jsyn.render_scene(jsyn.SyntheticSceneConfig(**dataclasses.asdict(cfg)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
