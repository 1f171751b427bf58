"""Analysis / synthesis transforms (g_a / g_s), ``plain``, ``plain_wam``
and ``rich`` variants, NCHW.

Counterpart of ``lic_tpu/models/transforms.py:42-158,161-182``:
4× (ZeroPad2d(1,2,1,2) + conv5 s2) with GDN after the first three, and
4× (ZeroPad2d(1,0,1,0) + deconv5 s2 p3 op1) each followed by IGDN.
``plain_wam`` adds the ``WinNoShiftAttention`` gates of
``model/source_net_WAM.py``: in g_a after the 2nd GDN (ws 8, shift 4, at
/4) and at the output (ws 4, shift 2, at /16); in g_s at the input (ws 4,
shift 2) and after the 2nd IGDN (ws 8, shift 4).  ``rich``
(``net_unet_ha_hs.py``): g_a replaces ``down0`` with three
``ResidualBottleneck``s on the image and a ``ResidualBlockWithStride``, and
``down2`` with three ``ResidualBottleneck``s and a second
``ResidualBlockWithStride``; g_s is ``plain_wam``'s but its ``wam1``
shifts by 2 at ws 8.  The layers are children in the order they run.  g_a
maps (H, W) → (H/16, W/16) and g_s inverts it exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (
    GDN,
    IGDN,
    Conv2d,
    ConvTranspose2d,
    ResidualBlockWithStride,
    ResidualBottleneck,
    WinNoShiftAttention,
)

VARIANTS = ("plain", "plain_wam", "rich")

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
    """g_a: 3 → N channels, /16 spatial."""

    def __init__(
        self, N: int, variant: str = "plain", *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown transform variant {variant!r}")
        g = generator
        wam, rich = variant != "plain", variant == "rich"
        if rich:
            for i in range(3):
                self.add_module(f"rb0_{i}", ResidualBottleneck(3, generator=g))
            self.rbs0 = ResidualBlockWithStride(3, N, 2, generator=g)
        else:
            self.down0 = _down5(3, N, g)
        self.gdn0 = GDN(N)
        self.down1 = _down5(N, N, g)
        self.gdn1 = GDN(N)
        if wam:
            self.wam0 = WinNoShiftAttention(N, 8, 8, 4, generator=g)
        if rich:
            for i in range(3):
                self.add_module(f"rb1_{i}", ResidualBottleneck(N, generator=g))
            self.rbs1 = ResidualBlockWithStride(N, N, 2, generator=g)
        else:
            self.down2 = _down5(N, N, g)
        self.gdn2 = GDN(N)
        self.down3 = _down5(N, N, g)
        if wam:
            self.wam1 = WinNoShiftAttention(N, 8, 4, 2, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class SynthesisTransform(nn.Module):
    """g_s: ``in_channels`` (default N) → ``out_channels``, ×16 spatial.
    The neural-syntax family feeds it the N − M content channels (flax
    infers the width from the input)."""

    def __init__(
        self, N: int, out_channels: int, variant: str = "plain", *,
        in_channels: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown transform variant {variant!r}")
        g = generator
        wam = variant != "plain"
        if wam:
            self.wam0 = WinNoShiftAttention(N, 8, 4, 2, generator=g)
        filters = [N, N, N, out_channels]
        cin = in_channels or N
        for i, f in enumerate(filters):
            self.add_module(f"up{i}", _Up5(cin, f, g))
            self.add_module(f"igdn{i}", IGDN(f))
            if wam and i == 1:
                shift = 2 if variant == "rich" else 4
                self.wam1 = WinNoShiftAttention(f, 8, 8, shift, generator=g)
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
