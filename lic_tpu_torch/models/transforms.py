"""Analysis / synthesis transforms (g_a / g_s), plain variant, NCHW.

Counterpart of ``lic_tpu/models/transforms.py:42-67,107-122,161-167``:
4× (ZeroPad2d(1,2,1,2) + conv5 s2) with GDN after the first three, and
4× (ZeroPad2d(1,0,1,0) + deconv5 s2 p3 op1) each followed by IGDN.
g_a maps (H, W) → (H/16, W/16) and g_s inverts it exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import GDN, IGDN, Conv2d, ConvTranspose2d

# torch ZeroPad2d((1, 2, 1, 2)) + Conv2d(5, 2, 0): (left, right, top, bottom)
_DOWN_PAD = (1, 2, 1, 2)


def _down5(cin: int, cout: int, generator) -> Conv2d:
    return Conv2d(cin, cout, 5, 2, _DOWN_PAD, generator=generator)


class _Up5(nn.Module):
    """ZeroPad2d((1,0,1,0)) + ConvTranspose2d(5, 2, 3, output_padding=1):
    exact H → 2H."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.deconv = ConvTranspose2d(cin, cout, 5, 2, 3, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(F.pad(x, (1, 0, 1, 0)))


class AnalysisTransform(nn.Module):
    """g_a: 3 → N channels, /16 spatial (plain variant)."""

    def __init__(self, N: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down0 = _down5(3, N, generator)
        self.gdn0 = GDN(N)
        self.down1 = _down5(N, N, generator)
        self.gdn1 = GDN(N)
        self.down2 = _down5(N, N, generator)
        self.gdn2 = GDN(N)
        self.down3 = _down5(N, N, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gdn0(self.down0(x))
        x = self.gdn1(self.down1(x))
        x = self.gdn2(self.down2(x))
        return self.down3(x)


class SynthesisTransform(nn.Module):
    """g_s: N → ``out_channels``, ×16 spatial (plain variant)."""

    def __init__(
        self, N: int, out_channels: int, *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        filters = [N, N, N, out_channels]
        cin = N
        for i, f in enumerate(filters):
            self.add_module(f"up{i}", _Up5(cin, f, generator))
            self.add_module(f"igdn{i}", IGDN(f))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"igdn{i}")(getattr(self, f"up{i}")(x))
        return x
