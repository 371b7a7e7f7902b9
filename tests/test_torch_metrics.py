"""fruitnerf_tpu_torch.utils.metrics against fruitnerf_tpu.utils.metrics on
the same images, made by numpy from a seed. Float32 on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu.utils import metrics as jm
from fruitnerf_tpu_torch.utils import metrics as tm

# PSNR and IoU: float32 sums over a few thousand values; SSIM: two
# separable matrix products against one 2-D convolution
ATOL = 1e-5


def _images(seed, h=37, w=29):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.1, target.shape), 0, 1).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_match_jax(seed):
    pred, target = _images(seed)
    for fn in ("psnr", "ssim"):
        got = float(getattr(tm, fn)(torch.from_numpy(pred), torch.from_numpy(target)))
        want = float(getattr(jm, fn)(jnp.asarray(pred), jnp.asarray(target)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6, err_msg=fn)


def test_ssim_bounds_and_flat_regions():
    """ssim(x, x) = 1; an anticorrelated image scores below 0; on a
    near-flat image the variance clamp keeps the map inside [-1, 1]."""
    pred, _ = _images(2)
    x = torch.from_numpy(pred)
    assert abs(float(tm.ssim(x, x)) - 1.0) < 1e-5
    assert float(tm.ssim(x, 1.0 - x)) < 0.0
    # variances of ~1e-9 under E[x^2] - mu^2 of ~0.5: float32 cancellation
    # noise, so only the bound is compared (the two sum in other orders)
    flat = np.full((24, 24, 3), 0.7, np.float32)
    flat[::3] += 1e-4
    got = float(tm.ssim(torch.from_numpy(flat), torch.from_numpy(flat[::-1].copy())))
    assert -1.0 <= got <= 1.0


@pytest.mark.parametrize("case", ["random", "empty_both", "empty_pred"])
def test_iou_matches_jax(case):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (31, 23)).astype(np.float32)
    mask = (rng.uniform(size=(31, 23)) > 0.6).astype(np.float32)
    if case == "empty_both":
        logits[:], mask[:] = -5.0, 0.0
    elif case == "empty_pred":
        logits[:] = -5.0
    for fn in ("binary_iou", "binary_iou_reference_quirk"):
        got = float(getattr(tm, fn)(torch.from_numpy(logits), torch.from_numpy(mask)))
        want = float(getattr(jm, fn)(jnp.asarray(logits), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=fn)
