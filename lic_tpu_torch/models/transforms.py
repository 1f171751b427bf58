"""Analysis / synthesis transforms (g_a / g_s), ``plain``, ``plain_wam``,
``rich`` and ``rbs`` variants, NCHW.

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
shifts by 2 at ws 8.  ``rbs`` (``lic_tpu/models/transforms.py:197-232``,
the working assembly of the reference's ``synthesisTransformModel_RBS``) is
a g_s only; its g_a is ``rich``'s (``lic_tpu/models/codec.py:95-97``).  Its
g_s: ``rbs_wam0`` (ws 4, shift 2), then at each of three scales a
``ResidualBlockUpsample`` (×2) with three ``ResidualBottleneck``s and an
IGDN (a stride-1 3×3 ``ConvTranspose2d`` after the first IGDN,
``rbs_wam1`` (ws 8, shift 2) after the second), then ``_Up5`` + IGDN.  The
layers are children in the order they run.  g_a maps (H, W) → (H/16,
W/16) and g_s inverts it exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import conv_direct
from ..layers import (
    GDN,
    IGDN,
    Conv2d,
    ConvTranspose2d,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    ResidualBottleneck,
    WinNoShiftAttention,
)

VARIANTS = ("plain", "plain_wam", "rich", "rbs")

# torch ZeroPad2d((1, 2, 1, 2)) + Conv2d(5, 2, 0): (left, right, top, bottom)
_DOWN_PAD = (1, 2, 1, 2)


def _down5(cin: int, cout: int, generator) -> Conv2d:
    return Conv2d(cin, cout, 5, 2, _DOWN_PAD, generator=generator)


class _Up5(nn.Module):
    """ZeroPad2d((1,0,1,0)) + ConvTranspose2d(5, 2, 3, output_padding=1):
    exact H → 2H.  Where ``kernel_slot`` says so, both go to
    ``conv_direct.up5`` (one kernel on the card, the same function's
    polyphase plain version on the CPU); else to ``F.pad`` and
    ``F.conv_transpose2d``."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.deconv = ConvTranspose2d(cin, cout, 5, 2, 3, 1, generator=generator)

    def kernel_slot(self, x: torch.Tensor) -> Optional[str]:
        """``'up5'`` where a call on ``x`` takes the deconv kernel: a C_in
        that is a multiple of 4 (the kernel's TMA loads need rows of whole
        16 bytes), on any device."""
        return "up5" if x.shape[1] % 4 == 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_slot(x) == "up5":
            return conv_direct.up5(x, self.deconv.weight, self.deconv.bias)
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
        wam, rich = variant != "plain", variant in ("rich", "rbs")
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
        cin = in_channels or N
        if variant == "rbs":
            self._rbs(N, out_channels, cin, g)
            return
        wam = variant != "plain"
        if wam:
            self.wam0 = WinNoShiftAttention(N, 8, 4, 2, generator=g)
        filters = [N, N, N, out_channels]
        for i, f in enumerate(filters):
            self.add_module(f"up{i}", _Up5(cin, f, g))
            self.add_module(f"igdn{i}", IGDN(f))
            if wam and i == 1:
                shift = 2 if variant == "rich" else 4
                self.wam1 = WinNoShiftAttention(f, 8, 8, shift, generator=g)
            cin = f

    def _rbs(self, N: int, out_channels: int, cin: int, g) -> None:
        f0, f1, f2, f3 = N, N, N, out_channels
        add = self.add_module
        self.rbs_wam0 = WinNoShiftAttention(cin, 8, 4, 2, generator=g)
        self.rbs_up0 = ResidualBlockUpsample(cin, f0, 2, generator=g)
        for i in range(3):
            add(f"rbs_rb0_{i}", ResidualBottleneck(f0, generator=g))
        self.rbs_igdn0 = IGDN(f0)
        self.rbs_deconv3 = ConvTranspose2d(f0, f0, 3, 1, 1, 0, generator=g)
        self.rbs_up1 = ResidualBlockUpsample(f0, f1, 2, generator=g)
        self.rbs_igdn1 = IGDN(f1)
        self.rbs_wam1 = WinNoShiftAttention(f1, 8, 8, 2, generator=g)
        for i in range(3):
            add(f"rbs_rb1_{i}", ResidualBottleneck(f1, generator=g))
        self.rbs_up2 = ResidualBlockUpsample(f1, f2, 2, generator=g)
        self.rbs_igdn2 = IGDN(f2)
        for i in range(3):
            add(f"rbs_rb2_{i}", ResidualBottleneck(f2, generator=g))
        self.rbs_up3 = _Up5(f2, f3, g)
        self.rbs_igdn3 = IGDN(f3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
