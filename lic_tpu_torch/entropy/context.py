"""Spatial context model of the neural-syntax family: causal patch sampling
and the per-position (μ, σ) head, NCHW.

Counterpart of ``lic_tpu/entropy/context.py:27-100``.  Patch geometry:
``patch[i, j](p, q) = x_pad[p + i, q + j + 1]`` for i, j in [0, 4) on the
latent padded by 3 on every side, i.e. rows −3..0 and columns −2..+1
around (p, q); ``masked`` zeroes (3, 2) and (3, 3), the position itself and
its right neighbour.  A patch tensor is (P, C, 4, 4), P running over
(b, h, w) in raster order.

``PredictionModelContext.head`` — conv3 s1 → LReLU(0.2) → conv3 s2 →
LReLU → conv3 s1 → LReLU → flatten → FC → (μ, exp(log σ)).  The flatten
is the JAX package's NHWC order (h, w, c), so its FC weights carry over
as they are.  The third conv (C_in = N, 3×3 on 2×2 maps) takes kernel B6
at N = 192 (``layers.conv``'s gate, as the JAX package's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, Linear
from ..layers.conv_direct import leaky_relu


def block_sample(x: torch.Tensor, masked: bool = True) -> torch.Tensor:
    """(B, C, H, W) → (B·H·W, C, 4, 4) causal context patches."""
    b, c, h, w = x.shape
    xp = F.pad(x, (3, 3, 3, 3))
    rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            sl = xp[:, :, i : i + h, j + 1 : j + 1 + w]
            if masked and i == 3 and j >= 2:
                sl = torch.zeros_like(sl)
            cols.append(sl)
        rows.append(torch.stack(cols, dim=-1))  # (B, C, H, W, 4)
    t = torch.stack(rows, dim=-2)  # (B, C, H, W, 4, 4)
    return t.permute(0, 2, 3, 1, 4, 5).reshape(b * h * w, c, 4, 4)


def neighbor_sample(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B·H·W, C, 5, 5) unmasked 5×5 neighbourhoods."""
    b, c, h, w = x.shape
    xp = F.pad(x, (2, 2, 2, 2))
    t = torch.stack([torch.stack([xp[:, :, i : i + h, j : j + w] for j in range(5)], dim=-1)
                     for i in range(5)], dim=-2)
    return t.permute(0, 2, 3, 1, 4, 5).reshape(b * h * w, c, 5, 5)


class PredictionModelContext(nn.Module):
    """Per-position head over concatenated (y, h) context patches:
    ``in_channels`` = the latent's + the hyper's, ``dim`` the convs'
    width, ``outdim`` = 2·(latent channels)."""

    def __init__(self, in_channels: int, dim: int, outdim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.outdim = outdim
        self.c0 = Conv2d(in_channels, dim, 3, 1, 1, generator=g)
        self.c1 = Conv2d(dim, dim, 3, 2, 1, generator=g)
        self.c2 = Conv2d(dim, dim, 3, 1, 1, generator=g)
        self.fc = Linear(4 * dim, outdim, generator=g)

    def forward(self, y_rounded: torch.Tensor, h_tilde: torch.Tensor, masked: bool = True):
        """(μ, σ), each (B, outdim/2, H, W)."""
        b, _, h, w = y_rounded.shape
        merged = torch.cat([block_sample(y_rounded, masked), block_sample(h_tilde, False)], dim=1)
        mu, sigma = self.head(merged)
        c = self.outdim // 2
        to_map = lambda t: t.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return to_map(mu), to_map(sigma)

    def head(self, merged: torch.Tensor):
        """(P, C_y + C_h, 4, 4) patches → (μ, σ), each (P, outdim/2)."""
        c = self.outdim // 2
        t = merged.contiguous(memory_format=torch.channels_last)
        t = leaky_relu(self.c0(t), 0.2)
        t = leaky_relu(self.c1(t), 0.2)
        t = leaky_relu(self.c2(t), 0.2)
        out = self.fc(t.permute(0, 2, 3, 1).reshape(t.shape[0], -1))
        return out[:, :c], torch.exp(out[:, c:])
