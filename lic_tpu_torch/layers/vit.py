"""Vision Transformer (counterpart of ``lic_tpu/layers/vit.py``): the
timm-style ViT of the reference's ``model/vit_model.py``, which no model of
either package builds.

* ``PatchEmbed`` — a p×p stride-p conv; tokens in row-major order, (B, n, E).
* ``ViTAttention`` — ``qkv`` Linear, q·kᵀ·hd^−½ and its softmax in fp32,
  ``proj``.
* ``ViTBlock`` — LN → attention → +res, LN → fc1 → GELU (erf) → fc2 → +res.
* ``VisionTransformer`` — cls token, position table (truncated normal, σ
  0.02), ``depth`` blocks, the final LN; the cls feature, through
  ``pre_logits`` (Linear + tanh) and ``head`` where asked for.  NCHW image
  in.  The token count comes from ``img_size`` (flax reads it off the
  input).
* ``vit_base_patch16_224`` and ``vit_latent_syntax`` (img 16, patch 2,
  embed 12: the reference's latent syntax extractor).

flax's ``LayerNorm`` takes ε = 1e-6.  Parameter names follow the flax tree
(``patch_embed/proj``, ``block0/attn/qkv``, ``norm``), so ``utils.params``
carries them.  Plain matmuls and a softmax: the JAX package computes them
with XLA einsums, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv2d, Linear, gelu

_EPS = 1e-6  # flax.linen.LayerNorm's default


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int = 3, patch_size: int = 16, embed_dim: int = 768, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if x.shape[2] % p or x.shape[3] % p:
            raise ValueError(f"{tuple(x.shape[2:])} not divisible by {p}")
        return self.proj(x).flatten(2).transpose(1, 2)


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q, k, v = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.matmul((q * hd ** -0.5).float(), k.float().transpose(-1, -2))
        out = torch.matmul(F.softmax(attn, dim=-1).to(v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = ViTAttention(dim, num_heads, qkv_bias, generator=g)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.fc1 = Linear(dim, int(dim * mlp_ratio), generator=g)
        self.fc2 = Linear(int(dim * mlp_ratio), dim, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 num_classes: int = 0, representation_size: Optional[int] = None,
                 in_chans: int = 3, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        n = (img_size // patch_size) ** 2
        self.depth = depth
        self.patch_embed = PatchEmbed(in_chans, patch_size, embed_dim, generator=g)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, embed_dim))
        with torch.no_grad():  # flax truncated_normal(0.02): N(0, 0.02²) cut at ±2σ
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04, generator=g)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(embed_dim, num_heads, mlp_ratio, generator=g))
        self.norm = nn.LayerNorm(embed_dim, eps=_EPS)
        self.pre_logits = (Linear(embed_dim, representation_size, generator=g)
                           if representation_size else None)
        width = representation_size or embed_dim
        self.head = Linear(width, num_classes, generator=g) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embed(x)
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        feat = self.norm(tokens)[:, 0]
        if self.pre_logits is not None:
            feat = torch.tanh(self.pre_logits(feat))
        if self.head is not None:
            feat = self.head(feat)
        return feat


def vit_base_patch16_224(num_classes: int = 1000, *,
                         generator: Optional[torch.Generator] = None) -> VisionTransformer:
    return VisionTransformer(224, 16, 768, 12, 12, num_classes=num_classes, generator=generator)


def vit_latent_syntax(num_classes: int = 16, in_chans: int = 3, *,
                      generator: Optional[torch.Generator] = None) -> VisionTransformer:
    """img_size 16, patch 2, embed 12, 12 blocks of 12 heads
    (``vit_model.py:328-343``)."""
    return VisionTransformer(img_size=16, patch_size=2, embed_dim=12, depth=12, num_heads=12,
                             num_classes=num_classes, in_chans=in_chans, generator=generator)
