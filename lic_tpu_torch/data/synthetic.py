"""Synthetic test images made from a seed (no corpus needed)."""

from __future__ import annotations

import numpy as np


def smooth_images(rng: np.random.Generator, b: int, h: int, w: int) -> np.ndarray:
    """Low-frequency sinusoids plus gradients in [-1, 1], (B, 3, H, W) fp32."""
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=np.float32),
        np.linspace(0, 1, w, dtype=np.float32), indexing="ij",
    )
    out = np.empty((b, 3, h, w), np.float32)
    for i in range(b):
        for c in range(3):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            gx, gy = rng.uniform(-0.5, 0.5, 2)
            img = 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
            img += 0.3 * np.cos(2 * np.pi * rng.uniform(0.5, 2.0) * xx * yy)
            out[i, c] = np.clip(img + gx * (xx - 0.5) + gy * (yy - 0.5), -1, 1)
    return out
