"""Residual blocks and the conv attention gate (counterpart of
``lic_tpu/layers/blocks.py:37-243``), NCHW.

* ``ResidualBlock`` — conv3×3 → LeakyReLU → conv3×3 → LeakyReLU, + the
  input (through a 1×1 conv where the width changes).  Both LeakyReLUs
  ride the convs' ``fused_act``; in kernel B6's slot (128 < C <= 192) the
  skip-add rides the second conv's epilogue.
* ``ResidualBlock3x3`` is the same block (``Block_unet.py:367-398``);
  ``ResidualBlock3_5`` has a 5×5 between two 3×3s, ``ResidualBlock5x5``
  one 5×5.
* ``ResidualUnit`` — 1×1 → ReLU → 3×3 → ReLU → 1×1, + the input, ReLU.
* ``ResidualBottleneck`` — 1×1 (C → C/2) → GELU → 3×3 → GELU → 1×1, + the
  input (exact erf GELU).
* ``ResidualBlockWithStride`` — conv3×3 stride s → LeakyReLU → conv3×3 →
  GDN, + a strided 1×1 of the input.
* ``ResidualBlockUpsample`` (``lic_tpu/layers/blocks.py:112-132``) —
  subpel 3×3 (×r) → LeakyReLU → conv3×3 → IGDN, + a second subpel 3×3 of
  the input.  Its conv3×3 at 128 < C <= 192 takes kernel B6, its IGDN B2;
  the subpel convs are ``F.conv2d`` as the JAX module's ``lax.conv``.
* ``AttentionBlock`` — ``a · σ(b) + x`` with ``a`` = 3 ``ResidualUnit``s
  and ``b`` = 3 ``ResidualUnit``s + 1×1 over ``b_input`` (default x).

Every residual branch's last conv is zero-init (``residual_out_init``), so
each block starts as the identity.  ``FLAX_NAMES`` maps a child's name to
the name flax gives it (``Conv2d_0``, ``GDN_0``, ``ResidualUnit_3``…);
``utils.params`` reads it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .conv import Conv2d, SubpelConv2d, gelu
from .conv_direct import leaky_relu
from .gdn import GDN, IGDN


def _zero(conv: Conv2d) -> Conv2d:
    nn.init.zeros_(conv.weight)  # residual_out_init
    return conv


class ResidualBlock(nn.Module):
    FLAX_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1", "skip": "Conv2d_2"}

    def __init__(self, in_channels: int, features: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = features or in_channels, generator
        self.conv1 = Conv2d(in_channels, n, 3, 1, 1, fused_act="leaky_relu", generator=g)
        self.conv2 = _zero(Conv2d(n, n, 3, 1, 1, fused_act="leaky_relu", generator=g))
        self.skip = Conv2d(in_channels, n, 1, generator=g) if n != in_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.conv2(self.conv1(x), residual=identity)


ResidualBlock3x3 = ResidualBlock


class ResidualBlock3_5(nn.Module):
    FLAX_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1", "conv3": "Conv2d_2",
                  "skip": "Conv2d_3"}

    def __init__(self, in_channels: int, features: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = features or in_channels, generator
        self.conv1 = Conv2d(in_channels, n, 3, 1, 1, fused_act="leaky_relu", generator=g)
        self.conv2 = Conv2d(n, n, 5, 1, 2, fused_act="leaky_relu", generator=g)
        self.conv3 = _zero(Conv2d(n, n, 3, 1, 1, fused_act="leaky_relu", generator=g))
        self.skip = Conv2d(in_channels, n, 1, generator=g) if n != in_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.conv3(self.conv2(self.conv1(x)), residual=identity)


class ResidualBlock5x5(nn.Module):
    FLAX_NAMES = {"conv": "Conv2d_0", "skip": "Conv2d_1"}

    def __init__(self, in_channels: int, features: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = features or in_channels, generator
        self.conv = _zero(Conv2d(in_channels, n, 5, 1, 2, fused_act="leaky_relu", generator=g))
        self.skip = Conv2d(in_channels, n, 1, generator=g) if n != in_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.conv(x, residual=identity)


class ResidualUnit(nn.Module):
    FLAX_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1", "conv3": "Conv2d_2"}

    def __init__(self, features: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = features, generator
        self.conv1 = Conv2d(n, n // 2, 1, generator=g)
        self.conv2 = Conv2d(n // 2, n // 2, 3, 1, 1, generator=g)
        self.conv3 = _zero(Conv2d(n // 2, n, 1, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv2(torch.relu(self.conv1(x))))
        return torch.relu(self.conv3(out) + x)


class ResidualBottleneck(nn.Module):
    FLAX_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1", "conv3": "Conv2d_2"}

    def __init__(self, features: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = features, generator
        self.conv1 = Conv2d(n, n // 2, 1, generator=g)
        self.conv2 = Conv2d(n // 2, n // 2, 3, 1, 1, generator=g)
        self.conv3 = _zero(Conv2d(n // 2, n, 1, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv3(gelu(self.conv2(gelu(self.conv1(x)))))


class ResidualBlockWithStride(nn.Module):
    FLAX_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1", "gdn": "GDN_0",
                  "skip": "Conv2d_2"}

    def __init__(self, in_channels: int, features: int, stride: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, fused_act="leaky_relu",
                            generator=g)
        self.conv2 = _zero(Conv2d(features, features, 3, 1, 1, generator=g))
        self.gdn = GDN(features)
        self.skip = (Conv2d(in_channels, features, 1, stride, generator=g)
                     if stride != 1 or in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.gdn(self.conv2(self.conv1(x))) + identity


class ResidualBlockUpsample(nn.Module):
    FLAX_NAMES = {"subpel": "SubpelConv2d_0", "conv": "Conv2d_0", "igdn": "GDN_0",
                  "skip": "SubpelConv2d_1"}

    def __init__(self, in_channels: int, features: int, upsample: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.subpel = SubpelConv2d(in_channels, features, upsample, generator=g)
        self.conv = _zero(Conv2d(features, features, 3, 1, 1, generator=g))
        self.igdn = IGDN(features)
        self.skip = SubpelConv2d(in_channels, features, upsample, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.igdn(self.conv(leaky_relu(self.subpel(x)))) + self.skip(x)


class AttentionBlock(nn.Module):
    """``a · σ(b) + x``; ``b_input`` replaces x on the b branch (SWAtten)."""

    FLAX_NAMES = {**{f"ru{i}": f"ResidualUnit_{i}" for i in range(6)}, "conv": "Conv2d_0"}

    def __init__(self, features: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(6):
            self.add_module(f"ru{i}", ResidualUnit(features, generator=generator))
        self.conv = Conv2d(features, features, 1, generator=generator)

    def forward(self, x: torch.Tensor, b_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.ru2(self.ru1(self.ru0(x)))
        b = self.conv(self.ru5(self.ru4(self.ru3(x if b_input is None else b_input))))
        return a * torch.sigmoid(b) + x
