"""Swin-style window attention (counterpart of
``lic_tpu/layers/win_attention.py:149-368``).

* ``WindowAttention`` — W-MSA with relative position bias on the padded,
  rolled NHWC map.  Its parameters are the flax tree's: ``qkv`` (C → 3C),
  ``proj`` (C → C, zero-init) and ``relative_position_bias_table``
  ((2ws-1)², nh), in the reference's layout.  The core is kernel B4
  (``window_attention``) between the two projections, or, with
  ``fuse_proj`` (the JAX package's ``set_pallas_attn(..., fuse_proj=True)``),
  kernel B5 (``window_attention_proj``) with both projections inside.  The
  parameters are the same either way.  On the card the kernels run at every
  size they are built for (``b4_takes``/``b5_takes``).  On a padded map of
  fewer than 4096 tokens, the JAX package's own gate below which it runs
  XLA, never its Pallas kernels (``lic_tpu/layers/win_attention.py:305``),
  a ``fuse_proj`` shape B5 does not take runs B4 between the two
  ``Linear``s, and a shape B4 does not take runs ``wba_plain_route`` (the
  plain version, counted like a kernel).  At or above 4096 tokens such a
  shape goes to the kernel's wrapper, which raises on the card.  The gate
  reads the shape only: on the CPU every wrapper runs its plain version.
* ``WinBasedAttention`` — pad to the window grid, cyclic shift, W-MSA with
  the additive −100 shift/pad mask, roll back, crop, residual.
* ``WinNoShiftAttention`` — the two-branch gate ``a · σ(b) + x``
  (``ResidualBlock`` ×3 against attention interleaved with 1×1 / 3×3 / 7×7
  convs and ``ResidualBlock``s).

Modules take NCHW tensors in ``channels_last`` memory; the attention core
works on the NHWC view of the same bytes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ResidualBlock
from .conv import Conv2d, Linear
from .window_attn import (
    b4_takes,
    b5_takes,
    rel_index,
    shift_mask,
    wba_plain,
    window_attention,
    window_attention_proj,
)

_BIAS_STD = 0.02
# the JAX gate: its Pallas attention runs only on maps of this many tokens
# or more (lic_tpu/layers/win_attention.py:305)
PLAIN_ROUTE_TOKENS = 4096


def wba_plain_route(qkv, rel, mask, ws: int, nh: int) -> torch.Tensor:
    """``wba_plain`` for a (ws, head width) B4 does not take on a map of
    fewer than ``PLAIN_ROUTE_TOKENS`` tokens; counted in
    ``wba_plain_route.launches``."""
    wba_plain_route.launches += 1
    return wba_plain(qkv, rel, mask, ws, nh)


wba_plain_route.launches = 0


class WindowAttention(nn.Module):
    def __init__(
        self, dim: int, window_size: int, num_heads: int, fuse_proj: bool = False,
        *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        ws = window_size
        self.window_size = ws
        self.num_heads = num_heads
        self.fuse_proj = fuse_proj
        table = torch.empty((2 * ws - 1) ** 2, num_heads)
        nn.init.trunc_normal_(table, 0.0, _BIAS_STD, -2 * _BIAS_STD, 2 * _BIAS_STD,
                              generator=generator)
        self.relative_position_bias_table = nn.Parameter(table)
        self.qkv = Linear(dim, 3 * dim, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)
        nn.init.zeros_(self.proj.weight)  # residual_out_init

    def route(self, x: torch.Tensor) -> str:
        """How a call on the NHWC map ``x`` runs, by its shape: ``'wba_proj'``
        (B5), ``'wba'`` (B4 between the ``Linear``s) or ``'plain'``
        (``wba_plain_route``)."""
        ws, nh = self.window_size, self.num_heads
        _, hp, wp, c = x.shape
        gated = hp * wp < PLAIN_ROUTE_TOKENS
        if self.fuse_proj and (b5_takes(ws, c, c // nh) or not gated):
            return "wba_proj"
        if b4_takes(ws, c // nh) or not gated:
            return "wba"
        return "plain"

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, Hp, Wp, C) NHWC; mask: (nW, n, n) or None."""
        ws, nh = self.window_size, self.num_heads
        n = ws * ws
        idx = rel_index(ws, x.device)
        rel = self.relative_position_bias_table[idx].reshape(n, n, nh).permute(2, 0, 1)
        route = self.route(x)
        if route == "wba_proj":
            return window_attention_proj(
                x, rel, self.qkv.weight, self.qkv.bias, self.proj.weight,
                self.proj.bias, mask, ws, nh,
            )
        core = window_attention if route == "wba" else wba_plain_route
        return self.proj(core(self.qkv(x), rel, mask, ws, nh))


class WinBasedAttention(nn.Module):
    """Swin block: optional cyclic shift + (S)W-MSA + residual."""

    def __init__(
        self, dim: int, num_heads: int = 8, window_size: int = 8,
        shift_size: int = 0, *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not 0 <= shift_size < window_size:
            raise ValueError("shift_size must be in [0, window_size)")
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn = WindowAttention(dim, window_size, num_heads, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        ws, ss = self.window_size, self.shift_size
        pad_b, pad_r = (-h) % ws, (-w) % ws
        t = x.permute(0, 2, 3, 1)  # NHWC: contiguous for channels_last x
        if pad_b or pad_r:
            t = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
        if ss > 0:
            t = torch.roll(t, shifts=(-ss, -ss), dims=(1, 2))
        t = self.attn(t, shift_mask(h, w, ws, ss, pad_b, pad_r, x.device))
        if ss > 0:
            t = torch.roll(t, shifts=(ss, ss), dims=(1, 2))
        return x + t[:, :h, :w].permute(0, 3, 1, 2)


class WinNoShiftAttention(nn.Module):
    """``a · σ(b) + x``.  Despite the name it shifts when ``shift_size > 0``,
    exactly like the reference (``layers/layers.py:56-111``)."""

    def __init__(
        self, dim: int, num_heads: int = 8, window_size: int = 8,
        shift_size: int = 0, *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        wba = lambda: WinBasedAttention(dim, num_heads, window_size, shift_size, generator=g)
        self.conv_a = nn.ModuleList(ResidualBlock(dim, generator=g) for _ in range(3))
        self.wba0 = wba()
        self.c1x1 = Conv2d(dim, dim, 1, generator=g)
        self.wba1 = wba()
        self.rb1 = ResidualBlock(dim, generator=g)
        self.c3x3 = Conv2d(dim, dim, 3, 1, 1, generator=g)
        self.wba2 = wba()
        self.rb2 = ResidualBlock(dim, generator=g)
        self.c7x7 = Conv2d(dim, dim, 7, 1, 3, generator=g)
        self.wba3 = wba()
        self.rb3 = ResidualBlock(dim, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x
        for blk in self.conv_a:
            a = blk(a)
        b = x
        for layer in (self.wba0, self.c1x1, self.wba1, self.rb1, self.c3x3,
                      self.wba2, self.rb2, self.c7x7, self.wba3, self.rb3):
            b = layer(b)
        return a * torch.sigmoid(b) + x
