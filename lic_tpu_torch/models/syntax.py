"""Neural-syntax machinery, basic variant (counterpart of
``lic_tpu/models/syntax.py:46-125``).

* ``SyntaxModel`` — pooling pyramid over the first M latent channels →
  M-dim syntax vector (B, M, 1, 1).
* ``ConvGenerator`` — MLP M→128→256→3·M giving each image the weights of
  the decoder's final 1x1 conv, with the JAX package's head init.
* ``batch_conv`` — the per-image generated 1x1 conv, one batched einsum
  (the JAX package, too, computes it outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, Linear


def _gap(x: torch.Tensor) -> torch.Tensor:
    """Global average pool to (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


class SyntaxModel(nn.Module):
    """Pyramid: pool(x) ∥ pool(down0) ∥ pool(down1) → 1x1 conv."""

    def __init__(
        self, in_dim: int, out_dim: int, *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.down0 = Conv2d(in_dim, 32, 3, 2, 1, generator=generator)
        self.down1 = Conv2d(32, 64, 3, 2, 1, generator=generator)
        self.out_conv = Conv2d(in_dim + 96, out_dim, 1, generator=generator)

    def forward(self, syntax: torch.Tensor) -> torch.Tensor:
        d0 = torch.relu(self.down0(syntax))
        d1 = torch.relu(self.down1(d0))
        out = torch.cat([_gap(syntax), _gap(d0), _gap(d1)], dim=1)
        return self.out_conv(out)


class ConvGenerator(nn.Module):
    """Syntax vector (B, M, 1, 1) → per-image 1x1 conv weights
    (B, 3, out_dim)."""

    def __init__(
        self, in_dim: int, out_dim: int, *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.out_dim = out_dim
        self.fc0 = Linear(in_dim, 128, generator=generator)
        self.fc1 = Linear(128, 256, generator=generator)
        # small fan-avg kernel + nonzero bias: keeps the decode tail alive
        # and linear at init (see lic_tpu/models/syntax.py:100-106)
        self.fc2 = Linear(
            256, out_dim * 3, kernel_scale=0.01, fan_avg=True, bias_std=0.2,
            generator=generator,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = F.leaky_relu(self.fc0(x.reshape(b, -1)), 0.2)
        x = F.leaky_relu(self.fc1(x), 0.2)
        return self.fc2(x).reshape(b, 3, self.out_dim)


def batch_conv(weights: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """weights: (B, C_out, C_in); inputs: (B, C_in, H, W) → (B, C_out, H, W)."""
    return torch.einsum("bchw,boc->bohw", inputs, weights)
