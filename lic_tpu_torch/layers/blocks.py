"""``ResidualBlock`` (counterpart of ``lic_tpu/layers/blocks.py:19-81``).

conv3×3 → LeakyReLU → conv3×3 → LeakyReLU, + the input.  Both LeakyReLUs
ride the convs' ``fused_act``; at 128 < C <= 192 the two convs are kernel
B6's slot and the skip-add rides the second one's epilogue.  The second
conv is zero-init (``residual_out_init``): every block starts as the
identity.  The 1×1 skip of the JAX block for a change of channel count is
not ported: every ``ResidualBlock`` of the ported presets keeps its width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .conv import Conv2d


class ResidualBlock(nn.Module):
    def __init__(self, features: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1, fused_act="leaky_relu",
                            generator=generator)
        self.conv2 = Conv2d(features, features, 3, 1, 1, fused_act="leaky_relu",
                            generator=generator)
        nn.init.zeros_(self.conv2.weight)  # residual_out_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x), residual=x)
