"""Image-quality and segmentation metrics: PSNR, SSIM, IoU. Twin of
``fruitnerf_tpu/utils/metrics.py``; each returns a 0-dim float32 tensor."""
from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-10))


def _gaussian_1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / torch.sum(g)


def _valid_filter(n: int, g: torch.Tensor) -> torch.Tensor:
    """[n-k+1, n] banded matrix M: (M @ x)[i] = sum_j g[j] x[i+j], a
    'VALID' correlation with the k taps of g."""
    k = g.shape[0]
    rows = torch.arange(n - k + 1, device=g.device)[:, None]
    m = torch.zeros((n - k + 1, n), dtype=g.dtype, device=g.device)
    m[rows, rows + torch.arange(k, device=g.device)] = g
    return m


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Standard SSIM with an 11x11 Gaussian window (sigma 1.5), 'VALID'
    borders. pred/target: [H, W, C]. The window is separable, so each
    filter is two float32 matrix products (no convolution, whose cuDNN path
    may round to TF32)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    g = _gaussian_1d(11, 1.5, pred.device)
    h, w = pred.shape[0], pred.shape[1]
    mh, mw = _valid_filter(h, g), _valid_filter(w, g)

    def filt(img):  # [H, W, C] -> [C, H-10, W-10]
        return mh @ img.permute(2, 0, 1) @ mw.T

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    # E[x^2] - mu^2 cancels in float32 on near-flat regions and can go
    # slightly negative, pushing the map out of [-1, 1]; clamp at 0
    sigma_pp = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
    sigma_tt = torch.clamp(filt(target * target) - mu_tt, min=0.0)
    sigma_pt = filt(pred * target) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    return torch.mean(torch.clamp(num / den, -1.0, 1.0))


def _iou(pred: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gt = (mask > 0.5).float()
    inter = torch.sum(pred * gt)
    union = torch.sum(torch.clamp(pred + gt, 0.0, 1.0))
    return inter, union


def binary_iou(
    sem_logits: torch.Tensor, mask: torch.Tensor, threshold: float = 0.5
) -> torch.Tensor:
    """IoU of the sigmoid-thresholded fruit logit against the mask; 1 when
    both are empty."""
    pred = (torch.sigmoid(sem_logits) > threshold).float()
    inter, union = _iou(pred, mask)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), torch.ones_like(union))


def binary_iou_reference_quirk(sem_logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's IoU: a softmax over one logit is 1 everywhere, so
    the prediction is all ones. Logged beside ``binary_iou`` for parity."""
    inter, union = _iou(torch.ones_like(sem_logits), mask)
    return inter / torch.clamp(union, min=1.0)
