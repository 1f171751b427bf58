"""The latent-space transformer of the latent U-Nets (counterpart of
``lic_tpu/layers/spatial_transformer.py``), NCHW in and out.

* ``GEGLU`` — ``x, gate = Linear(dim → 2·dim_out)``; ``x · gelu(gate)``.
* ``FeedForward`` — GEGLU to ``mult · dim``, then Linear back to ``dim``.
* ``CrossAttention`` — multi-head attention, self-attention where
  ``context`` is None: bias-free ``to_q`` / ``to_k`` / ``to_v``, q scaled
  by ``dim_head^-½`` before the product, the scores and their softmax in
  fp32, then ``to_out`` with its bias.
* ``BasicTransformerBlock`` — LN → attn1 → +res, LN → attn2 → +res,
  LN → FeedForward → +res.
* ``SpatialTransformer`` — GroupNorm(32) → 1×1 ``proj_in`` → ``depth``
  blocks over the h·w tokens (row-major, as the JAX module's NHWC
  reshape orders them) → zero-init 1×1 ``proj_out`` → + the input.

flax's ``LayerNorm`` and ``GroupNorm`` take ε = 1e-6, not torch's 1e-5.
The JAX package computes the attention with XLA einsums, not a Pallas
kernel, and so does this module, with plain matmuls and a softmax.
``remat`` (the JAX module's ``nn.remat`` around each block) runs each
block under ``torch.utils.checkpoint`` when the module trains with
gradients on.  Parameter names follow the flax tree (``block_0/attn1/
to_q``, ``norm``, ``proj_in``), so ``utils.params`` carries them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .conv import Conv2d, Linear, gelu

_EPS = 1e-6  # flax.linen.LayerNorm's and GroupNorm's default


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Linear(dim, 2 * dim_out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        inner, g = dim * mult, generator
        self.geglu = GEGLU(dim, inner, generator=g)
        self.fc_out = Linear(inner, dim, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.geglu(x))


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, inner = generator, heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        context_dim = context_dim or query_dim
        self.to_q = Linear(query_dim, inner, bias=False, generator=g)
        self.to_k = Linear(context_dim, inner, bias=False, generator=g)
        self.to_v = Linear(context_dim, inner, bias=False, generator=g)
        self.to_out = Linear(inner, query_dim, generator=g)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, d = self.heads, self.dim_head
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).view(b, n, h, d).transpose(1, 2)
        k = self.to_k(context).view(b, m, h, d).transpose(1, 2)
        v = self.to_v(context).view(b, m, h, d).transpose(1, 2)
        sim = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        attn = F.softmax(sim, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.attn1 = CrossAttention(dim, n_heads, d_head, generator=g)
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn2 = CrossAttention(dim, n_heads, d_head, generator=g)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.ff = FeedForward(dim, generator=g)
        self.norm3 = nn.LayerNorm(dim, eps=_EPS)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 remat: bool = False, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, inner = generator, n_heads * d_head
        self.depth, self.remat = depth, remat
        self.norm = nn.GroupNorm(32, in_channels, eps=_EPS)
        self.proj_in = Conv2d(in_channels, inner, 1, generator=g)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, n_heads, d_head,
                                                                generator=g))
        self.proj_out = Conv2d(inner, in_channels, 1, generator=g)
        nn.init.zeros_(self.proj_out.weight)  # the reference's zero_module

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, h, w = x.shape
        y = self.proj_in(self.norm(x))
        inner = y.shape[1]
        y = y.flatten(2).transpose(1, 2)  # (b, h·w, inner), tokens row-major
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            y = (checkpoint(block, y, context, use_reentrant=False) if remat
                 else block(y, context))
        y = y.reshape(b, h, w, inner).permute(0, 3, 1, 2)  # NCHW, channels_last
        return self.proj_out(y) + x
