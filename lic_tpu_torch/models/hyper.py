"""Classic hyper-prior path (counterpart of ``lic_tpu/models/hyper.py:56-88``).

* h_a: |x| → conv3 s1 → ReLU → conv5 s2 → ReLU → conv5 s2 (N ch, /4)
* h_s: deconv5 s2 → ReLU → deconv5 s2 → ReLU → conv3 s1 (N ch, ×4)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers import Conv2d, ConvTranspose2d


class ClassicHyperAnalysis(nn.Module):
    def __init__(self, N: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv2d(N, N, 3, 1, 1, generator=generator)
        self.c1 = Conv2d(N, N, 5, 2, 2, generator=generator)
        self.c2 = Conv2d(N, N, 5, 2, 2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.c0(torch.abs(x)))
        x = torch.relu(self.c1(x))
        return self.c2(x)


class ClassicHyperSynthesis(nn.Module):
    def __init__(self, N: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d0 = ConvTranspose2d(N, N, 5, 2, 2, 1, generator=generator)
        self.d1 = ConvTranspose2d(N, N, 5, 2, 2, 1, generator=generator)
        self.c2 = Conv2d(N, N, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.d0(x))
        x = torch.relu(self.d1(x))
        return self.c2(x)
