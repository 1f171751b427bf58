"""Image metrics in the reference's rounded 0..255 domain
(``model/net.py:864-869``); counterpart of
``lic_tpu/evaluation/metrics.py``, on NCHW tensors.  ``torch.round`` and
``jnp.round`` both round half to even."""

from __future__ import annotations

import torch


def to_255(x_pm1: torch.Tensor) -> torch.Tensor:
    """[−1, 1] → rounded/clamped 0..255 floats."""
    return torch.round(torch.clamp((x_pm1 + 1.0) * 127.5, 0.0, 255.0))


def mse_255(x_pm1: torch.Tensor, y_pm1: torch.Tensor) -> torch.Tensor:
    """Per-image MSE after 0..255 rounding; gt is rounded, recon clamped —
    exactly the reference's accounting (``model/net.py:864-868``)."""
    gt = torch.round((x_pm1 + 1.0) * 127.5)
    xh = to_255(y_pm1)
    return torch.mean((xh - gt) ** 2, dim=(1, 2, 3))


def psnr_255(v_mse: torch.Tensor) -> torch.Tensor:
    return torch.mean(20.0 * torch.log10(255.0 / torch.sqrt(v_mse)))
