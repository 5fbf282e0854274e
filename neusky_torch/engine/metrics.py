"""Image metrics: PSNR, MSE, SSIM on the host, LPIPS on a device (the
port's own copy of ``neusky_tpu/engine/metrics.py``).

SSIM is Wang et al.'s with an 11×11 Gaussian window (σ 1.5) over the valid
region, in float64 with numpy.  LPIPS is :mod:`neusky_torch.engine.lpips`;
report :func:`lpips_flavour` beside it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from neusky_torch.engine import lpips as _lpips


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    mse_ = float(np.mean((pred - target) ** 2))
    if mse_ <= 1e-12:
        return 100.0
    return float(10.0 * np.log10(data_range**2 / mse_))


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean((pred - target) ** 2))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g)


def _conv2d_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """[H, W] * [k, k] → [H-k+1, W-k+1] over sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    return np.einsum("ijkl,kl->ij", sliding_window_view(img, kernel.shape), kernel)


def ssim_image(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM of two [H, W, C] (or [H, W]) images, channels averaged."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    window = _gaussian_window()
    if pred.ndim == 2:
        pred, target = pred[..., None], target[..., None]
    vals = []
    for c in range(pred.shape[-1]):
        x = pred[..., c].astype(np.float64)
        y = target[..., c].astype(np.float64)
        mu_x = _conv2d_valid(x, window)
        mu_y = _conv2d_valid(y, window)
        mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
        sigma_x = _conv2d_valid(x * x, window) - mu_x2
        sigma_y = _conv2d_valid(y * y, window) - mu_y2
        sigma_xy = _conv2d_valid(x * y, window) - mu_xy
        s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / ((mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def lpips_image(pred: np.ndarray, target: np.ndarray, device="cuda") -> float:
    """LPIPS (VGG16 taps) of two [H, W, 3] images in [0, 1], computed on
    ``device``."""
    return _lpips.lpips(pred, target, device)[0]


def lpips_flavour() -> Optional[str]:
    """``"vgg16-pretrained"`` | ``"vgg16-random"`` once LPIPS has run,
    else None."""
    return _lpips.flavour()
