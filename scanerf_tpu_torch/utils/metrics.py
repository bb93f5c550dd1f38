"""Image quality metrics on tensors: PSNR and gaussian-window SSIM
(counterpart of ``scanerf_tpu/utils/metrics.py``).

PSNR over [0, max_val] images, SSIM with an 11x11 gaussian window of
sigma 1.5 and C1 / C2 from K = 0.01 / 0.03 at L = 1. Both clip the
prediction to the displayable range first: the reference evaluates
saved 8-bit images, so accumulation overshoot must not reach the metric.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR of ``pred`` (clipped to [0, max_val]) against ``gt``."""
    pred = pred.clamp(0.0, max_val)
    mse = ((pred - gt) ** 2).mean()
    return 10.0 * torch.log10(max_val**2 / mse.clamp_min(1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g)


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of an [H, W, C] image pair in [0, 1]. ``pred`` is clipped
    to [0, 1] and the variance estimates ``E[x^2] - mu^2`` are floored at
    0 (f32 cancellation can take them below it)."""
    pred = pred.clamp(0.0, 1.0)
    C = pred.shape[-1]
    win = torch.tensor(_gaussian_window(window_size, sigma), dtype=pred.dtype,
                       device=pred.device).expand(C, 1, window_size, window_size)

    def conv(x):  # [H, W, C] -> per-channel valid convolution, [H', W', C]
        y = torch.nn.functional.conv2d(x.permute(2, 0, 1)[None], win, groups=C)
        return y[0].permute(1, 2, 0)

    mu1, mu2 = conv(pred), conv(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = (conv(pred * pred) - mu1_sq).clamp_min(0.0)
    s2 = (conv(gt * gt) - mu2_sq).clamp_min(0.0)
    s12 = conv(pred * gt) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return ssim_map.mean()
