"""Training losses: L1/L2 and windowed SSIM (port of ``gs_deformable_tpu/utils/losses.py``).

SSIM uses the reference's normalized 11-tap Gaussian window (sigma 1.5), its
zero "same" padding and its constants C1 = 0.01^2, C2 = 0.03^2.  The 2D
window is separable, so the blur runs as shifted multiply-adds along each
axis in the JAX version's order: the same float operations, and no
convolution that cuDNN could run in TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    with tracing.span("gs.loss"):
        return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Depthwise zero-padded 'same' filtering of (C, H, W), height then width."""
    k = win.shape[0]
    pad = k // 2

    def blur_axis(x, dim):
        size = x.shape[dim]
        pads = [0, 0, 0, 0]
        pads[2 * (x.dim() - 1 - dim):2 * (x.dim() - dim)] = [pad, pad]
        xp = F.pad(x, pads)
        acc = None
        for j in range(k):
            term = float(win[j]) * xp.narrow(dim, j, size)
            acc = term if acc is None else acc + term
        return acc

    return blur_axis(blur_axis(img, 1), 2)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM over a (C, H, W) image pair."""
    win = _gaussian_window(window_size, sigma)
    C = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    f = _filter2d(stacked, win)
    mu1, mu2 = f[0:C], f[C:2 * C]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = f[2 * C:3 * C] - mu1_sq
    sigma2_sq = f[3 * C:4 * C] - mu2_sq
    sigma12 = f[4 * C:5 * C] - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair."""
    with tracing.span("gs.loss"):
        return ssim_map(img1, img2, window_size, sigma).mean()
