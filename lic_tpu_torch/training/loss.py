"""Rate-distortion loss and (MS-)SSIM, in plain torch on NCHW images.

Counterpart of ``lic_tpu/training/loss.py``: ``λ·255²·MSE + bpp`` with MSE
in the [−1, 1] domain (``train_net_unet.py:180``), or ``λ·(1 − MS-SSIM) +
bpp``; MS-SSIM with separable 11-tap Gaussian windows (σ 1.5), the
standard five scale weights, 2×2 average pooling between scales, fewer
scales (weights renormalized) for images too small for five, and the
per-scale values clamped at 1e-6 before the weighted product.  None of it
is a kernel in the JAX package either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur, valid padding; x (B, C, H, W)."""
    c, n = x.shape[1], k.numel()
    x = F.conv2d(x, k.view(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         return_cs: bool = False):
    """Mean SSIM over (B, C, H, W) images (and the mean contrast-structure
    term with ``return_cs``)."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    k = torch.from_numpy(_gaussian_kernel()).to(a.device, a.dtype)
    mu_a, mu_b = _blur(a, k), _blur(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # variances are non-negative in exact math; fp32 cancellation on flat
    # regions can drive them slightly negative
    sigma_aa = torch.clamp(_blur(a * a, k) - mu_aa, min=0.0)
    sigma_bb = torch.clamp(_blur(b * b, k) - mu_bb, min=0.0)
    sigma_ab = _blur(a * b, k) - mu_ab
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    if return_cs:
        return ssim_map.mean(), cs.mean()
    return ssim_map.mean()


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM (up to 5 scales, standard weights) of NCHW images."""
    levels = len(_MSSSIM_WEIGHTS)
    min_dim = min(a.shape[-2], a.shape[-1])
    while levels > 1 and (min_dim >> (levels - 1)) < 11:
        levels -= 1
    w = np.asarray(_MSSSIM_WEIGHTS[:levels])
    weights = torch.from_numpy((w / w.sum()).astype(np.float32)).to(a.device)
    vals = []
    for i in range(levels):
        s, cs = ssim(a, b, data_range=data_range, return_cs=True)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    # clamp at 1e-6, not 0: d(v^w)/dv at 0 is 0·∞
    vals = torch.clamp(torch.stack(vals), min=1e-6)
    return torch.prod(vals ** weights.to(vals.dtype))


def msssim_db(v: torch.Tensor) -> torch.Tensor:
    """−10·log10(1 − msssim), the form the reference prints."""
    return -10.0 * torch.log10(1.0 - v)


def rate_distortion_loss(
    bpp: torch.Tensor, mse: torch.Tensor, lmbda: float, loss_type: str = "mse",
    msssim_val: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if loss_type == "mse":
        return lmbda * (255.0 ** 2) * mse + bpp
    if msssim_val is None:
        raise ValueError(f"loss_type {loss_type!r} needs msssim_val")
    return lmbda * (1.0 - msssim_val) + bpp
