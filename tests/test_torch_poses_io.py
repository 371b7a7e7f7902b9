"""The port's image and mask loading (``data/poses_io.py``) and its panel
writer (``scripts/render.py:_save``) against the JAX package's, on files of
every kind a capture may hold: PNGs of each colour type, bit depth and
interlacing, and JPEGs. Every comparison is bit-equal: both read and write
through Pillow, and the loaders' float32 ``/ 255`` is the same operation on
the same uint8 values. Inputs come from numpy seeds."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fruitnerf_tpu.data import poses_io as jax_io
from fruitnerf_tpu.scripts import render as jax_render
from fruitnerf_tpu_torch.data import poses_io
from fruitnerf_tpu_torch.scripts import render


def _interlaced_rgb(pixels: np.ndarray) -> bytes:
    """A 2 x 2 RGB Adam7 PNG (Pillow writes none): pass 1 holds (0,0),
    pass 6 (0,1), pass 7 row 1."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    stream = b"".join(b"\0" + p.tobytes() for p in (pixels[0, :1], pixels[0, 1:], pixels[1]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(stream)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Images and masks as a capture may hold them, written by Pillow."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(np.dstack([rgb, rng.integers(0, 256, (24, 30), dtype=np.uint8)])).save(
        d / "rgba.png")
    Image.fromarray(rgb[..., :2], "LA").save(d / "la.png")
    Image.fromarray(rgb).save(d / "rgb.jpg", quality=90)
    pal = Image.fromarray(rng.integers(0, 256, (19, 27), dtype=np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 768).tolist())
    pal.save(d / "palette.png")
    Image.fromarray(rng.integers(0, 65536, (9, 11), dtype=np.uint16)).save(d / "deep.png")
    (d / "adam7.png").write_bytes(_interlaced_rgb(rng.integers(0, 256, (2, 2, 3), dtype=np.uint8)))
    mask = (rng.random((24, 30)) > 0.6).astype(np.uint8)
    Image.fromarray(mask * 255).save(d / "mask255.png")
    Image.fromarray(mask).save(d / "mask01.png")
    Image.fromarray(mask.astype(bool)).save(d / "mask_1bit.png")
    Image.fromarray(np.dstack([mask * 255] * 3)).save(d / "mask_rgb.png")
    Image.fromarray(mask * 255).save(d / "mask.jpg", quality=75)  # JPEG ringing: 125 threshold
    Image.fromarray((rng.random((24, 30)) * 255).astype(np.uint8)).save(d / "soft.png")
    return d


@pytest.mark.parametrize("name", ["rgb.png", "rgba.png", "la.png", "rgb.jpg", "palette.png",
                                  "deep.png", "adam7.png", "mask255.png", "mask_1bit.png"])
def test_load_image_equals_jax(image_files, name):
    got, want = poses_io.load_image(image_files / name), jax_io.load_image(image_files / name)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mask255.png", "mask01.png", "mask_1bit.png", "mask_rgb.png",
                                  "mask.jpg", "soft.png", "palette.png", "la.png"])
def test_load_mask_equals_jax(image_files, name):
    """The reference's mask rule on each kind of file: JPEG at 125, > 1
    divided by 255, [0, 1] passed through."""
    got, want = poses_io.load_mask(image_files / name), jax_io.load_mask(image_files / name)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jpg", [False, True])
def test_normalize_mask_array_equals_jax(jpg):
    rng = np.random.default_rng(7)
    for arr in (rng.integers(0, 256, (5, 6)).astype(np.uint8), rng.random((5, 6))):
        np.testing.assert_array_equal(poses_io.normalize_mask_array(arr, jpg),
                                      jax_io.normalize_mask_array(arr, jpg))


def test_load_image_round_trips_uint8():
    """``dataset_from_parsed``'s ``(clip(x) * 255).astype(uint8)`` of ``load_image``'s
    ``x / 255`` returns every uint8 value."""
    v = np.arange(256, dtype=np.uint8)
    back = (np.clip(v.astype(np.float32) / 255.0, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(back, v)


@pytest.mark.parametrize("shape", [(12, 17), (12, 17, 1), (12, 17, 3)])
def test_render_panels_equal_jax(tmp_path, shape):
    """A depth-like 2-D panel (min-max scaled), a one-channel panel and an
    RGB panel are written as the JAX render writes them."""
    arr = np.random.default_rng(8).random(shape).astype(np.float32) * (3.0 if len(shape) == 2 else 1.0)
    render._save(arr, tmp_path / "port.png")
    jax_render._save(arr, tmp_path / "jax.png")
    got, want = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert got.mode == want.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
