"""Neural-syntax machinery (counterpart of ``lic_tpu/models/syntax.py:30-125``).

* ``SyntaxModel`` — pooling pyramid over the first M latent channels →
  M-dim syntax vector (B, M, 1, 1).  ``basic``: two strided 3×3 convs;
  ``wam``: three, each after a ``DepthwiseSeparableConv`` (depthwise 3×3 +
  pointwise 1×1), with a ``WinNoShiftAttention`` gate (C 64, ws 4, shift
  2: kernel B4 at head width 8) after the second.
* ``ConvGenerator`` — MLP M→128→256→3·M giving each image the weights of
  the decoder's final 1x1 conv, with the JAX package's head init.
* ``batch_conv`` — the per-image generated 1x1 conv, one batched einsum
  (the JAX package, too, computes it outside any Pallas kernel).
* ``PredictionModelSyntax`` — hyper features → pooled pyramid → FC →
  (μ, σ = exp) of the syntax vector (``lic_tpu/models/syntax.py:128-156``):
  the neural-syntax family codes its syntax stream with it.  The charm
  configs build it too, but no charm forward calls it: there the port's
  ``CodecModel`` leaves it out, and ``utils.checkpoint`` uses it only for
  that subtree of the ``.npz`` files.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers import Conv2d, DepthwiseConv2d, Linear, WinNoShiftAttention
from ..layers.conv_direct import leaky_relu


def _gap(x: torch.Tensor) -> torch.Tensor:
    """Global average pool to (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3×3 + pointwise 1×1."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depthwise = DepthwiseConv2d(in_dim, generator=generator)
        self.pointwise = Conv2d(in_dim, out_dim, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class SyntaxModel(nn.Module):
    """Pyramid: pool(x) ∥ pool(each stage) → 1x1 conv."""

    def __init__(
        self, in_dim: int, out_dim: int, variant: str = "basic", *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        if variant not in ("basic", "wam"):
            raise ValueError(f"unknown syntax variant {variant!r}")
        self.wam_variant = variant == "wam"
        if self.wam_variant:
            self.dw0 = DepthwiseSeparableConv(in_dim, in_dim, generator=g)
        self.down0 = Conv2d(in_dim, 32, 3, 2, 1, generator=g)
        if self.wam_variant:
            self.dw1 = DepthwiseSeparableConv(32, 32, generator=g)
        self.down1 = Conv2d(32, 64, 3, 2, 1, generator=g)
        if self.wam_variant:
            self.wam = WinNoShiftAttention(64, 8, 4, 2, generator=g)
            self.dw2 = DepthwiseSeparableConv(64, 64, generator=g)
            self.down2 = Conv2d(64, 128, 3, 2, 1, generator=g)
        pooled = in_dim + 96 + (128 if self.wam_variant else 0)
        self.out_conv = Conv2d(pooled, out_dim, 1, generator=g)

    def forward(self, syntax: torch.Tensor) -> torch.Tensor:
        if not self.wam_variant:
            d0 = torch.relu(self.down0(syntax))
            d1 = torch.relu(self.down1(d0))
            out = torch.cat([_gap(syntax), _gap(d0), _gap(d1)], dim=1)
            return self.out_conv(out)
        d0 = torch.relu(self.down0(self.dw0(syntax)))
        d1 = self.wam(torch.relu(self.down1(self.dw1(d0))))
        d2 = torch.relu(self.down2(self.dw2(d1)))
        out = torch.cat([_gap(syntax), _gap(d0), _gap(d1), _gap(d2)], dim=1)
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
        x = leaky_relu(self.fc0(x.reshape(b, -1)), 0.2)
        x = leaky_relu(self.fc1(x), 0.2)
        return self.fc2(x).reshape(b, 3, self.out_dim)


def batch_conv(weights: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """weights: (B, C_out, C_in); inputs: (B, C_in, H, W) → (B, C_out, H, W)."""
    return torch.einsum("bchw,boc->bohw", inputs, weights)


class PredictionModelSyntax(nn.Module):
    """Hyper features → (μ, σ) of the syntax vector, each (B, outdim/2,
    1, 1): ``down0``, ``down1`` (3×3 stride 2, ReLU), the ``'wam'`` gate,
    the pooled pyramid and ``fc`` (flax names and inits).  Returns the
    intended (μ, σ), not the reference's swapped unpack."""

    def __init__(self, in_dim: int, dim: int, outdim: int, variant: str = "basic", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.down0 = Conv2d(in_dim, dim, 3, 2, 1, generator=g)
        self.down1 = Conv2d(dim, dim, 3, 2, 1, generator=g)
        if variant == "wam":
            self.wam = WinNoShiftAttention(dim, 8, 4, 2, generator=g)
        self.fc = Linear(in_dim + 2 * dim, outdim, generator=g)
        self.outdim = outdim

    def forward(self, h_tilde: torch.Tensor):
        b, c = h_tilde.shape[0], self.outdim // 2
        ds0 = torch.relu(self.down0(h_tilde))
        ds1 = torch.relu(self.down1(ds0))
        if hasattr(self, "wam"):
            ds1 = self.wam(ds1)
        ctx = torch.cat([_gap(h_tilde), _gap(ds0), _gap(ds1)], dim=1).reshape(b, -1)
        out = self.fc(ctx)
        return out[:, :c].reshape(b, c, 1, 1), torch.exp(out[:, c:]).reshape(b, c, 1, 1)
