"""Image quality metrics: MSE / PSNR / SSIM (and DSSIM) in torch (port of
dfnet_tpu/utils/metrics.py; reference script/models/metrics.py, kornia's
ssim with an 11x11 window).

Arguments are (H, W, C) or (B, H, W, C) images, as the JAX package takes
them: tensors on any device, or numpy arrays (taken to the CPU). SSIM is
Wang et al.'s uniform-window form over VALID windows, the value kornia
gives under reduction='mean'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def mse(image_pred, image_gt, valid_mask=None, reduction: str = "mean"):
    value = (_t(image_pred) - _t(image_gt)) ** 2
    if valid_mask is not None:
        value = value[_t(valid_mask)]
    return value.mean() if reduction == "mean" else value


def psnr(image_pred, image_gt, valid_mask=None, reduction: str = "mean"):
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask, reduction))


def _avg_pool_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) mean filter over win x win windows, VALID padding."""
    return Fn.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1).permute(0, 2, 3, 1)


def ssim(image_pred, image_gt, window: int = 11, max_val: float = 1.0,
         reduction: str = "mean"):
    """SSIM over (H, W, C) or (B, H, W, C) images in [0, max_val]."""
    x, y = _t(image_pred), _t(image_gt)
    x = x if x.ndim == 4 else x[None]
    y = y if y.ndim == 4 else y[None]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _avg_pool_valid(x, window)
    mu_y = _avg_pool_valid(y, window)
    sigma_x = _avg_pool_valid(x * x, window) - mu_x ** 2
    sigma_y = _avg_pool_valid(y * y, window) - mu_y ** 2
    sigma_xy = _avg_pool_valid(x * y, window) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    s = num / den
    return s.mean() if reduction == "mean" else s


def dssim(image_pred, image_gt, window: int = 11, max_val: float = 1.0):
    """Structural dissimilarity (kornia's convention): (1 - SSIM) / 2."""
    return (1.0 - ssim(image_pred, image_gt, window, max_val)) / 2.0
