"""The reference's dormant components (counterpart of
``lic_tpu/layers/misc.py``), which no model of either package builds;
NCHW modules.

* ``MaskedConv2d`` — PixelCNN A/B masked k×k conv, Xavier-uniform kernel
  (``model/ops.py:8-20``): mask A zeroes the centre tap and every tap after
  it in raster order, mask B keeps the centre.
* ``GSDN`` — subtract a learned channel mixture, then divide by
  sqrt(β + Γx²); the inverse multiplies, then adds (``model/ops.py:139-236``).
* ``space_to_depth`` / ``depth_to_space`` — r×r pixel (un)shuffle on NHWC
  tensors, the JAX functions' layout and channel order
  (``model/net.py:151-180``); ``layers.entroformer`` takes them from here.
* ``LinearAttention`` — softmax over the positions of k, context kᵀv,
  then q·context (``model/attention.py:125-141``).
* ``SpatialSelfAttention`` — GroupNorm(32) + 1×1 q/k/v, attention over
  the whole map, 1×1 ``proj_out``, + the input
  (``model/attention.py:144-194``).
* ``BlockTrain`` — 12 ``ViTBlock``s over the h·w latent tokens with a cls
  token; the tokens and the blocks 3, 7 and 11 projected to a quarter of
  the width, concatenated and fused to ``out_channels``
  (``model/Block_unet.py:96-167``).  The position table's length comes
  from ``num_tokens`` (flax reads it off the input).
* ``UnetHaHs`` and the split ``UnetHa`` / ``UnetHs`` — the
  ``SpatialTransformer`` U-Net hyper pair that the ``_new`` variants
  replaced (``model/Block_unet.py:585-771``); ``UnetHs`` is told the
  width of the encoder's input, which flax reads off it.

The convs are the port's ``Conv2d`` / ``ConvTranspose2d``, so one in a
kernel slot (a stride-1 3×3 at 128 < C_in <= 192 goes to B6) takes it on
the card as the JAX gates send it; ``MaskedConv2d`` calls ``F.conv2d`` as
the JAX module calls ``lax.conv``.  Attention is plain matmuls and a
softmax, as the JAX package's XLA einsums.  Parameter names follow the
flax tree, so ``utils.params`` carries them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bounds import lower_bound
from .blocks import ResidualBottleneck
from .conv import Conv2d, ConvTranspose2d, Linear
from .spatial_transformer import SpatialTransformer
from .vit import ViTBlock

_EPS = 1e-6  # flax.linen.GroupNorm's default


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC (B, H, W, C) → (B, H/r, W/r, r·r·C), the JAX package's order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """The inverse of ``space_to_depth``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, c // (r * r))


class MaskedConv2d(Conv2d):
    """``Conv2d``'s parameters (``utils.params`` maps them as a conv's),
    the Xavier-uniform init of flax's ``xavier_uniform`` and a causal mask
    on the kernel; padding k//2, stride 1."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5,
                 mask_type: str = "A", *, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, features, kernel_size, 1, kernel_size // 2,
                         generator=generator)
        if mask_type not in ("A", "B"):
            raise ValueError(f"mask_type is 'A' or 'B', got {mask_type!r}")
        k = kernel_size
        limit = math.sqrt(6.0 / (in_channels * k * k + features * k * k))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -limit, limit, generator=generator)
        mask = torch.ones(k, k)
        c = k // 2
        mask[c, c + (mask_type == "B"):] = 0.0
        mask[c + 1:] = 0.0
        self.register_buffer("mask", mask, persistent=False)

    def kernel_slot(self, x: torch.Tensor) -> None:
        return None  # the JAX module calls lax.conv, never a Pallas slot

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.mask, self.bias, padding=self.padding)


class GSDN(nn.Module):
    def __init__(self, num_features: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, reparam_offset: float = 2 ** -18):
        super().__init__()
        c, self.inverse = num_features, inverse
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        # sqrt in float64, rounded once (XLA's sqrt is correctly rounded)
        sq = lambda t: torch.sqrt(t.double()).float()
        eye = gamma_init * torch.eye(c)
        self.beta = nn.Parameter(sq(torch.ones(c) + self.pedestal))
        self.gamma = nn.Parameter(sq(eye + self.pedestal))
        self.beta2 = nn.Parameter(torch.zeros(c))
        self.gamma2 = nn.Parameter(sq(eye + self.pedestal))

    def _reparam(self, p: torch.Tensor, bound: float) -> torch.Tensor:
        return lower_bound(p, bound) ** 2 - self.pedestal

    def _divisive(self, v):
        g, b = self._reparam(self.gamma, self.gamma_bound), self._reparam(self.beta, self.beta_bound)
        return torch.sqrt(torch.einsum("bihw,oi->bohw", v * v, g) + b[:, None, None])

    def _subtractive(self, v):
        g = self._reparam(self.gamma2, self.gamma_bound)
        b = self._reparam(self.beta2, self.beta_bound)
        return torch.einsum("bihw,oi->bohw", v, g) + b[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.inverse:
            x = x * self._divisive(x)
            return x + self._subtractive(x)
        x = x - self._subtractive(x)
        return x / self._divisive(x)


class LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, 3 * hidden, 1, bias=False, generator=generator)
        self.to_out = Conv2d(hidden, dim, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        nh, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).flatten(2).transpose(1, 2).reshape(b, h * w, 3, nh, d)
        q, k, v = qkv.unbind(2)
        k = F.softmax(k, dim=1)  # over positions
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(b, h, w, nh * d)
        return self.to_out(out.permute(0, 3, 1, 2))


class SpatialSelfAttention(nn.Module):
    def __init__(self, in_channels: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, in_channels
        self.norm = nn.GroupNorm(32, c, eps=_EPS)
        self.q = Conv2d(c, c, 1, generator=g)
        self.k = Conv2d(c, c, 1, generator=g)
        self.v = Conv2d(c, c, 1, generator=g)
        self.proj_out = Conv2d(c, c, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        attn = F.softmax(torch.matmul(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class BlockTrain(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_tokens: int,
                 embed_dim: int = 256, num_heads: int = 12, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, e = generator, embed_dim
        self.out_channels = out_channels
        self.chans_embed = Linear(in_channels, e, generator=g)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens + 1, e))
        for i in range(12):
            self.add_module(f"block{i}", ViTBlock(e, num_heads, generator=g))
        for j in range(4):
            self.add_module(f"fusion{j}", Linear(e, e // 4, generator=g))
        self.fusion = Linear(4 * (e // 4), out_channels, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tok = self.chans_embed(x.flatten(2).transpose(1, 2))
        y = torch.cat([self.cls_token.expand(b, -1, -1), tok], dim=1) + self.pos_embed
        fused = [self.fusion0(tok)]
        for i in range(12):
            y = getattr(self, f"block{i}")(y)
            if i in (3, 7, 11):
                fused.append(getattr(self, f"fusion{len(fused)}")(y[:, 1:]))
        out = self.fusion(torch.cat(fused, dim=-1))
        return out.transpose(1, 2).reshape(b, self.out_channels, h, w)


def _st(c: int, nh: int, d_head: int, depth: int, g) -> SpatialTransformer:
    return SpatialTransformer(c, nh, d_head, depth, generator=g)


def _deconv1(cin: int, cout: int, g) -> ConvTranspose2d:
    return ConvTranspose2d(cin, cout, 1, 1, 0, 0, generator=g)


class UnetHaHs(nn.Module):
    """The fused U-Net hyper (``Block_unet.py:585-666``)."""

    def __init__(self, in_channels: int = 192, out_channels: int = 320, num_heads: int = 8,
                 depth: int = 3, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, nh, half = generator, num_heads, in_channels // 2
        self.conv1 = Conv2d(in_channels - half, half, 1, generator=g)
        self.st1 = _st(half, nh, max(half // nh, 1), depth, g)
        self.down1 = Conv2d(2 * half, 256, 3, 2, 1, generator=g)
        self.conv2 = Conv2d(128, 128, 1, generator=g)
        self.st2 = _st(128, nh, 128 // nh, depth, g)
        self.down2 = Conv2d(256, 512, 3, 2, 1, generator=g)
        self.mid0 = ResidualBottleneck(512, generator=g)
        self.mid_st = _st(512, nh, 512 // nh, depth, g)
        self.mid1 = ResidualBottleneck(512, generator=g)
        self.conv3 = _deconv1(256, 256, g)
        self.st3 = _st(256, nh, 256 // nh, depth, g)
        self.up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1, generator=g)
        self.up3 = _deconv1(512, 256, g)
        self.conv4 = _deconv1(128, 128, g)
        self.st4 = _st(128, nh, 128 // nh, depth, g)
        self.up2 = ConvTranspose2d(256, 320, 5, 2, 2, 1, generator=g)
        self.up4 = _deconv1(320 + in_channels, out_channels, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[1] // 2
        d1 = torch.relu(self.down1(torch.cat([self.conv1(x[:, half:]),
                                              self.st1(x[:, :half])], dim=1)))
        d2 = torch.relu(self.down2(torch.cat([self.conv2(d1[:, 128:]),
                                              self.st2(d1[:, :128])], dim=1)))
        m = self.mid1(self.mid_st(self.mid0(d2)))
        u1 = torch.relu(self.up1(torch.cat([self.conv3(m[:, 256:]), self.st3(m[:, :256])], 1)))
        u1 = torch.relu(self.up3(torch.cat([u1, d1], dim=1)))
        u2 = torch.relu(self.up2(torch.cat([self.conv4(u1[:, 128:]),
                                            self.st4(u1[:, :128])], dim=1)))
        return self.up4(torch.cat([u2, x], dim=1))


class UnetHa(nn.Module):
    """The split U-Net hyper's encoder ``Unet_ha`` (``Block_unet.py:669-726``):
    → (z, middle, skip1, inp), the reference's 4-tuple."""

    def __init__(self, in_channels: int = 192, num_heads: int = 8, depth: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, nh, half = generator, num_heads, in_channels // 2
        self.st1 = _st(half, nh, max(96 // nh, 1), depth, g)
        self.conv1 = Conv2d(in_channels - half, half, 1, generator=g)
        self.down1 = Conv2d(2 * half, 256, 3, 2, 1, generator=g)
        self.conv2 = Conv2d(128, 128, 1, generator=g)
        self.st2 = _st(128, nh, 128 // nh, depth, g)
        self.down2 = Conv2d(256, 512, 3, 2, 1, generator=g)
        self.mid0 = ResidualBottleneck(512, generator=g)
        self.mid_st = _st(512, nh, 512 // nh, depth, g)
        self.mid1 = ResidualBottleneck(512, generator=g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        half = x.shape[1] // 2
        # the reference's split order: (trans, conv), Block_unet.py:708
        d1 = torch.relu(self.down1(torch.cat([self.conv1(x[:, half:]),
                                              self.st1(x[:, :half])], dim=1)))
        d2 = torch.relu(self.down2(torch.cat([self.conv2(d1[:, :128]),
                                              self.st2(d1[:, 128:])], dim=1)))
        m = self.mid1(self.mid_st(self.mid0(d2)))
        return m, m, d1, x


class UnetHs(nn.Module):
    """The split U-Net hyper's decoder ``Unet_hs`` (``Block_unet.py:729-770``)
    on ``UnetHa``'s 4-tuple; ``in_channels`` is the width of its ``inp``."""

    def __init__(self, out_channels: int = 320, num_heads: int = 8, depth: int = 3,
                 in_channels: int = 192, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, nh = generator, num_heads
        self.st3 = _st(256, nh, 256 // nh, depth, g)
        self.conv3 = _deconv1(256, 256, g)
        self.up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1, generator=g)
        self.up3 = _deconv1(512, 256, g)
        self.conv4 = _deconv1(128, 128, g)
        self.st4 = _st(128, nh, 128 // nh, depth, g)
        self.up2 = ConvTranspose2d(256, 320, 5, 2, 2, 1, generator=g)
        self.up4 = _deconv1(320 + in_channels, out_channels, g)

    def forward(self, z, middle, skip1, inp) -> torch.Tensor:
        # split orders (trans, conv), then (conv, trans): Block_unet.py:757,764
        u1 = torch.relu(self.up1(torch.cat([self.conv3(middle[:, 256:]),
                                            self.st3(middle[:, :256])], dim=1)))
        u1 = torch.relu(self.up3(torch.cat([u1, skip1], dim=1)))
        u2 = torch.relu(self.up2(torch.cat([self.conv4(u1[:, :128]),
                                            self.st4(u1[:, 128:])], dim=1)))
        return self.up4(torch.cat([u2, inp], dim=1))
