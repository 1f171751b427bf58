"""Seeded synthetic images, made on the device.

The formula of ``lic_tpu_torch/data/synthetic.py::smooth_images`` at
commit a087453 (low-frequency sinusoids plus gradients in [−1, 1]), with
each image's parameters drawn from ``rng`` in that function's order and
the pixels computed on ``device`` in one pass for the whole batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def smooth_images(rng: np.random.Generator, b: int, h: int, w: int, device) -> torch.Tensor:
    """(B, 3, H, W) float32 in [−1, 1] on ``device``, ``channels_last``."""
    params = np.empty((b, 3, 6), np.float64)
    for i in range(b):
        for c in range(3):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            gx, gy = rng.uniform(-0.5, 0.5, 2)
            params[i, c] = (fx, fy, ph, rng.uniform(0.5, 2.0), gx, gy)
    p = torch.from_numpy(params.astype(np.float32)).to(device)[..., None, None]
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    fx, fy, ph, fr, gx, gy = p.unbind(2)
    img = 0.5 * torch.sin(2 * math.pi * (fx * xx + fy * yy) + ph)
    img = img + 0.3 * torch.cos(2 * math.pi * fr * xx * yy)
    img = torch.clamp(img + gx * (xx - 0.5) + gy * (yy - 0.5), -1, 1)
    return img.contiguous(memory_format=torch.channels_last)
