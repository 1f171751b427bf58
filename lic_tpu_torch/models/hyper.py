"""Hyper-prior paths (counterpart of ``lic_tpu/models/hyper.py``), NCHW.

* classic — h_a: |x| → conv3 s1 → ReLU → conv5 s2 → ReLU → conv5 s2 (N ch,
  /4); h_s: deconv5 s2 → ReLU → deconv5 s2 → ReLU → conv3 s1 (N ch, ×4).
* elic (``net_ga``) — h_a: GELU conv3 stack N → 320 → 288 → 256 (s2) → 224
  → 192 (s2); h_s: conv3 → subpel ↑2 → conv3 → subpel ↑2 → conv3 head.
* unet (``net_ha``, ``net_unet_ha_hs``, ``net_unet_ha_hs_1``) —
  ``UnetHyperAnalysis`` splits the channels into a conv half and a
  ``WinBasedAttention`` half at each scale and returns the 512-channel
  middle at /4 as z, with the skips ``middle``, ``skip1`` (the /2
  feature) and ``inp`` (the latent itself); ``UnetHyperSynthesis``
  reads those encoder-side skips and never ẑ, as the reference's
  decoder does (``net_unet_ha_hs.py:880,892``), so the EntropyBottleneck
  on z is trained by the rate term and the aux loss alone and no stream
  can be decoded.  One decoder with two output heads (scales, means), or
  two one-headed decoders (``shared_hyper_decoder=False``).
* unet_dec (``net_unet_ha_hs_dec``) — ``DecodableUnetHyperSynthesis``
  re-synthesizes the skip pyramid from ẑ alone and runs
  ``UnetHyperSynthesis`` with two output heads: decodable.
* latent_unet (``net_unet``, ``net_unet_1``, ``net_unet_005_5``) —
  ``LatentUnet`` predicts (scales, means) from the unquantized latent:
  ``SpatialTransformer`` halves beside conv halves at /1, /2 and /4 of
  the latent, a 512-channel middle, nothing coded (no z, no
  EntropyBottleneck).

The U-Net hyper's attention runs at window 4 with head widths N/16 and 16
and at window 2 with 64, 32 and 16, none of which B4 is built for; every
such map is under 4096 tokens, so the card runs them on the plain route
(``layers.win_attention``), as the JAX package runs them through XLA.
The latent U-Net's 3×3 convs run at 48-256 channels, outside B6's gate
(128 < C_in ≤ 192), and its attention is plain torch, as the JAX
package's is XLA: it launches no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers import (
    Conv2d,
    ConvTranspose2d,
    ResidualBlock3_5,
    ResidualBlock3x3,
    ResidualBlock5x5,
    ResidualBottleneck,
    SpatialTransformer,
    SubpelConv2d,
    WinBasedAttention,
    gelu,
)


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


class ElicHyperAnalysis(nn.Module):
    """N → 320 → 288 → 256 (s2) → 224 → 192 (s2), GELU between."""

    DIMS = ((320, 1), (288, 1), (256, 2), (224, 1), (192, 2))

    def __init__(self, N: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = N
        for i, (f, s) in enumerate(self.DIMS):
            self.add_module(f"c{i}", Conv2d(cin, f, 3, s, 1, generator=generator))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.children())
        for conv in convs[:-1]:
            x = gelu(conv(x))
        return convs[-1](x)


class ElicHyperSynthesis(nn.Module):
    """192 → conv3 → subpel(224)↑2 → conv3(256) → subpel(288)↑2 → conv3(out)."""

    def __init__(self, out_channels: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.c0 = Conv2d(192, 192, 3, 1, 1, generator=g)
        self.up0 = SubpelConv2d(192, 224, 2, generator=g)
        self.c1 = Conv2d(224, 256, 3, 1, 1, generator=g)
        self.up1 = SubpelConv2d(256, 288, 2, generator=g)
        self.c2 = Conv2d(288, out_channels, 3, 1, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.c0, self.up0, self.c1, self.up1):
            x = gelu(layer(x))
        return self.c2(x)


def _cat(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat(ts, dim=1)


class UnetHyperAnalysis(nn.Module):
    """``Unet_ha_new``: → (z, middle, skip1, inp); z is the 512-channel
    middle at /4 of the latent."""

    def __init__(self, in_channels: int, num_heads: int = 8, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, in_channels
        half = c // 2
        self.attn0 = WinBasedAttention(half, num_heads, 4, 2, generator=g)
        self.conv1 = ResidualBlock3_5(c - half, generator=g)
        self.down0 = Conv2d(c, c, 1, generator=g)
        self.down1 = Conv2d(c, 256, 3, 2, 1, generator=g)
        self.conv2 = ResidualBlock5x5(128, generator=g)
        self.attn1 = WinBasedAttention(128, num_heads, 4, 2, generator=g)
        self.down3 = Conv2d(256, 256, 1, generator=g)
        self.down2 = Conv2d(256, 512, 3, 2, 1, generator=g)
        self.mid0 = ResidualBottleneck(512, generator=g)
        self.mid_attn = WinBasedAttention(512, num_heads, 2, 1, generator=g)
        self.mid1 = ResidualBottleneck(512, generator=g)

    def forward(self, x: torch.Tensor):
        half = x.shape[1] // 2
        trans_x = self.attn0(x[:, :half])
        conv_x = self.conv1(x[:, half:])
        d1 = self.down0(_cat(conv_x, trans_x)) + x
        d1 = gelu(self.down1(d1))
        conv_y = self.conv2(d1[:, 128:])
        trans_y = self.attn1(d1[:, :128])
        d2 = self.down3(_cat(conv_y, trans_y)) + d1
        d2 = gelu(self.down2(d2))
        m = self.mid1(self.mid_attn(self.mid0(d2)))
        return m, m, d1, x


class UnetHyperSynthesis(nn.Module):
    """``Unet_hs_new`` with its skips (``inp`` has ``inp_channels``);
    ``two_heads`` adds the second output projection ``up4b``, so one pass
    gives (scales, means)."""

    def __init__(self, out_channels: int, inp_channels: int, num_heads: int = 8,
                 two_heads: bool = False, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv3 = ResidualBlock3x3(256, generator=g)
        self.attn3 = WinBasedAttention(256, num_heads, 2, 1, generator=g)
        self.up0 = Conv2d(512, 512, 1, generator=g)
        self.up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1, generator=g)
        self.up3 = Conv2d(512, 256, 1, generator=g)
        self.conv4 = ResidualBlock3x3(128, generator=g)
        self.attn2 = WinBasedAttention(128, num_heads, 2, 1, generator=g)
        self.up5 = Conv2d(256, 256, 1, generator=g)
        self.up2 = ConvTranspose2d(256, 192, 5, 2, 2, 1, generator=g)
        self.up4 = ConvTranspose2d(192 + inp_channels, out_channels, 1, 1, 0, 0, generator=g)
        self.up4b = (ConvTranspose2d(192 + inp_channels, out_channels, 1, 1, 0, 0, generator=g)
                     if two_heads else None)

    def forward(self, z_hat, middle, skip1, inp):
        conv_u = self.conv3(middle[:, 256:])
        trans_u = self.attn3(middle[:, :256])
        u1 = self.up0(_cat(conv_u, trans_u)) + middle
        u1 = gelu(self.up1(u1))
        u1 = gelu(self.up3(_cat(u1, skip1)))
        conv_v = self.conv4(u1[:, 128:])
        trans_v = self.attn2(u1[:, :128])
        u2 = self.up5(_cat(conv_v, trans_v)) + u1
        u2 = gelu(self.up2(u2))
        u2 = _cat(u2, inp)
        out = self.up4(u2)
        return out if self.up4b is None else (out, self.up4b(u2))


class DecodableUnetHyperSynthesis(nn.Module):
    """The skip pyramid re-synthesized from ẑ (two deconv stages), then
    ``UnetHyperSynthesis`` as ``body``."""

    def __init__(self, out_channels: int, num_heads: int = 8, two_heads: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.skip_up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1, generator=g)
        self.skip_up2 = ConvTranspose2d(256, 192, 5, 2, 2, 1, generator=g)
        self.body = UnetHyperSynthesis(out_channels, 192, num_heads, two_heads, generator=g)

    def forward(self, z_hat: torch.Tensor):
        skip1 = gelu(self.skip_up1(z_hat))
        inp = gelu(self.skip_up2(skip1))
        return self.body(z_hat, z_hat, skip1, inp)


class LatentUnet(nn.Module):
    """``Unet`` / ``Unet_new`` (``lic_tpu/models/hyper.py:244-329``): the
    latent-space (scales, means) predictor.  ``variant='res'`` takes
    ``ResidualBottleneck`` conv halves, ``'conv1x1'`` 1×1 convs.  The
    stage-2 ``SpatialTransformer`` ``st2`` serves the down and the up
    path in both variants; under ``'res'`` the conv ``cb2`` does too,
    while ``'conv1x1'`` has its own ``cb4`` on the way up: one module
    called twice, one set of leaves.  ``two_heads`` adds ``up4b``, so
    one pass gives (scales, means)."""

    def __init__(self, in_channels: int = 192, out_channels: int = 192, num_heads: int = 8,
                 depth: int = 3, variant: str = "res", two_heads: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in ("res", "conv1x1"):
            raise ValueError(f"unknown latent U-Net variant {variant!r}")
        g, nh, c = generator, num_heads, in_channels
        half = c // 2
        self.res = variant == "res"

        def st(f):
            return SpatialTransformer(f, nh, f // nh, depth, generator=g)

        def conv(f):
            return (ResidualBottleneck(f, generator=g) if self.res
                    else Conv2d(f, f, 1, generator=g))

        self.st1, self.st2, self.st3 = st(half), st(128), st(256)
        self.cb1, self.cb2, self.cb3 = conv(half), conv(128), conv(256)
        self.cb4 = None if self.res else conv(128)
        self.down1 = Conv2d(c, 256, 3, 2, 1, generator=g)
        self.down2 = Conv2d(256, 512, 3, 2, 1, generator=g)
        self.mid = nn.ModuleList([ResidualBottleneck(512, generator=g), st(512),
                                  ResidualBottleneck(512, generator=g)])
        self.up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1, generator=g)
        self.up2 = ConvTranspose2d(256, 192, 5, 2, 2, 1, generator=g)
        self.up3 = ConvTranspose2d(512, 256, 1, 1, 0, 0, generator=g)
        self.up4 = ConvTranspose2d(192 + c, out_channels, 1, 1, 0, 0, generator=g)
        self.up4b = (ConvTranspose2d(192 + c, out_channels, 1, 1, 0, 0, generator=g)
                     if two_heads else None)

    @staticmethod
    def _split(x, conv_mod, trans_mod, conv_first: bool):
        """(conv, trans) on the two channel halves: the conv takes the
        first half where ``conv_first``, else the second (the reference's
        assignment differs per stage and per variant)."""
        half = x.shape[1] // 2
        if conv_first:
            return conv_mod(x[:, :half]), trans_mod(x[:, half:])
        return conv_mod(x[:, half:]), trans_mod(x[:, :half])

    def forward(self, x: torch.Tensor):
        res = self.res
        d1 = torch.relu(self.down1(_cat(*self._split(x, self.cb1, self.st1, res))))
        d2 = torch.relu(self.down2(_cat(*self._split(d1, self.cb2, self.st2, True))))
        m = d2
        for blk in self.mid:
            m = blk(m)
        u1 = torch.relu(self.up1(_cat(*self._split(m, self.cb3, self.st3, res))))
        u1 = torch.relu(self.up3(_cat(u1, d1)))
        cb = self.cb2 if res else self.cb4
        u2 = torch.relu(self.up2(_cat(*self._split(u1, cb, self.st2, True))))
        u2 = _cat(u2, x)
        out = self.up4(u2)
        return out if self.up4b is None else (out, self.up4b(u2))
