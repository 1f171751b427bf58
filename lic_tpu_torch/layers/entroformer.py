"""Entroformer blocks and the context models built from them.

Counterpart of ``lic_tpu/layers/entroformer.py``, whole file:

* ``EntroformerConfig``, ``relative_position_buckets`` (2-D binned
  relative positions: bucket 0 holds every pair beyond the L1 radius
  ``num_buckets // 2``);
* ``EntroformerAttention`` — multi-head attention with the
  contextual-product relative position term (scores += q·table[bucket]),
  an optional mask and the top-k filter (ties kept), scaled by the model
  dim's ``d ** -0.5``, not the head width's (``:88``);
* ``EntroformerBlock`` — pre-norm attention + pre-norm LeakyReLU(0.2)
  MLP, residual; flax ``LayerNorm``'s eps 1e-6;
* ``TransHyperScale`` and its space-to-depth / depth-to-space resampling;
* ``raster_causal_mask``, ``checkerboard_masks``;
* ``EntroformerContext`` in both modes ('raster', 'checkerboard').

Tokens are (B, L, D), as in the JAX package.  ``TransHyperScale`` and
``EntroformerContext`` take and return NCHW maps; inside they run on
tokens in raster (h, w) order.

The JAX attention builds an (L, L, hd) table of relative embeddings with a
one-hot matmul and contracts it with q.  Here q is contracted with the
(buckets, hd) table first and the (B, h, L, buckets) result gathered by
bucket: the same sum without the (L, L, hd) tensor (604 MB per layer and
pass at 512×768 for ``entroformer_cb_full``).  The JAX package has no
Pallas kernel here; neither has the port: matmuls, a gather and a softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .conv import Linear
from .conv_direct import leaky_relu
from .misc import depth_to_space, space_to_depth

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon
LEAKY_SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class EntroformerConfig:
    dim: int = 384
    num_layers: int = 6
    num_heads: int = 6
    dim_head: int = 64
    relative_attention_num_buckets: int = 5  # must be odd
    mlp_ratio: int = 4
    scale: bool = True
    attn_topk: int = -1
    is_decoder: bool = True


def relative_position_buckets(
    q_shape: Tuple[int, int], k_shape: Tuple[int, int], num_buckets: int
) -> np.ndarray:
    """(qv·qh, kv·kh) int32 bucket of every (query, key) pair."""
    if num_buckets % 2 == 0:
        raise ValueError(f"num_buckets must be odd, got {num_buckets}")
    half = num_buckets // 2
    qv, qh = q_shape
    kv, kh = k_shape
    rv = np.arange(kv)[None, :] - np.arange(qv)[:, None]
    rh = np.arange(kh)[None, :] - np.arange(qh)[:, None]
    rv_full = np.repeat(np.repeat(rv[:, None, :, None], qh, 1), kh, 3)
    rh_full = np.repeat(np.repeat(rh[None, :, None, :], qv, 0), kv, 2)
    ham = np.abs(rv_full) + np.abs(rh_full)
    buckets = (rv_full + half) * num_buckets + (rh_full + half)
    buckets = np.where(ham <= half, buckets, 0)
    return buckets.reshape(qv * qh, kv * kh).astype(np.int32)


def _dense(din: int, dout: int, bias: bool = True, zero: bool = False, generator=None):
    """flax ``nn.Dense`` with its init (zero-init where the JAX module
    passes ``zeros_init``)."""
    layer = Linear(din, dout, generator=generator)
    if not bias:
        layer.bias = None
    if zero:
        with torch.no_grad():
            layer.weight.zero_()
    return layer


class EntroformerAttention(nn.Module):
    """MHSA with the contextual-product relative position term."""

    def __init__(self, cfg: EntroformerConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.dim_head
        nb = cfg.relative_attention_num_buckets ** 2
        self.qkv = _dense(cfg.dim, 3 * inner, bias=False, generator=generator)
        # flax nn.Embed's default init: variance_scaling(1, fan_in, normal)
        # over the (nb, hd) table, fan_in = hd
        self.relative_attention_bias = nn.Parameter(torch.empty(nb, cfg.dim_head))
        with torch.no_grad():
            self.relative_attention_bias.normal_(0.0, cfg.dim_head ** -0.5, generator=generator)
        self.o = _dense(inner, cfg.dim, bias=False, zero=True, generator=generator)
        self._buckets = {}

    def buckets(self, shape_2d: Tuple[int, int], device) -> torch.Tensor:
        key = (tuple(shape_2d), str(device))
        if key not in self._buckets:
            b = relative_position_buckets(shape_2d, shape_2d,
                                          self.cfg.relative_attention_num_buckets)
            self._buckets[key] = torch.from_numpy(b.astype(np.int64)).to(device)
        return self._buckets[key]

    def forward(self, x: torch.Tensor, shape_2d: Tuple[int, int],
                mask: Optional[torch.Tensor] = None, topk: int = -1) -> torch.Tensor:
        """x (B, L, D); ``mask`` (L, L) bool, True = may attend."""
        cfg = self.cfg
        b, l, d = x.shape
        nh, hd = cfg.num_heads, cfg.dim_head
        scale = d ** -0.5 if cfg.scale else 1.0
        qkv = self.qkv(x).reshape(b, l, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, h, L, hd)
        scores = q @ k.transpose(-1, -2)
        # q·table[bucket[l, m]] = (q·tableᵀ)[..., bucket[l, m]]
        qe = q @ self.relative_attention_bias.t()  # (B, h, L, nb)
        idx = self.buckets(shape_2d, x.device)
        ctx = torch.gather(qe, 3, idx.expand(b, nh, l, l))
        scores = (scores + ctx) * scale
        neg = torch.finfo(scores.dtype).min
        if mask is not None:
            scores = scores.masked_fill(~mask, neg)
        if 0 < topk < l:
            thresh = torch.topk(scores, topk, dim=-1).values[..., -1:]
            scores = torch.where(scores >= thresh, scores, neg)
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, l, nh * hd)
        return self.o(out)


class EntroformerBlock(nn.Module):
    """PreNorm attention + PreNorm LeakyReLU(0.2) MLP, residual."""

    def __init__(self, cfg: EntroformerConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.attn = EntroformerAttention(cfg, generator=generator)
        self.ln_mlp = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.fc1 = _dense(cfg.dim, cfg.dim * cfg.mlp_ratio, generator=generator)
        self.fc2 = _dense(cfg.dim * cfg.mlp_ratio, cfg.dim, zero=True, generator=generator)

    def forward(self, x, shape_2d, mask=None, topk=-1):
        x = x + self.attn(self.ln_attn(x), shape_2d, mask, topk)
        h = leaky_relu(self.fc1(self.ln_mlp(x)), LEAKY_SLOPE)
        return x + self.fc2(h)


class TransHyperScale(nn.Module):
    """Transformer hyper transform over latent tokens, shifting resolution
    by ``2**scale`` (``down``: encoder, space-to-depth merges; else
    decoder, depth-to-space expansions).  NCHW in and out."""

    def __init__(self, cin: int, cout: int, scale: int = 2, down: bool = True,
                 cfg: EntroformerConfig = EntroformerConfig(dim=192, num_layers=2,
                                                            num_heads=6, dim_head=32),
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cin, self.scale, self.down, self.cfg = cin, scale, down, cfg
        d = cfg.dim
        self.proj_in = _dense(cin, d, generator=g)
        for s in range(scale + 1):
            for i in range(cfg.num_layers):
                self.add_module(f"s{s}_block{i}", EntroformerBlock(cfg, generator=g))
            if s < scale:
                if down:
                    self.add_module(f"merge{s}", _dense(4 * d, d, generator=g))
                else:
                    self.add_module(f"expand{s}", _dense(d, 4 * d, generator=g))
        self.proj_out = _dense(d, cout, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.cin:
            raise ValueError(f"TransHyperScale expects cin={self.cin} channels, got "
                             f"{x.shape[1]}")
        cfg, d = self.cfg, self.cfg.dim
        x = self.proj_in(x.permute(0, 2, 3, 1))
        for s in range(self.scale + 1):
            b, h, w, _ = x.shape
            tokens = x.reshape(b, h * w, d)
            for i in range(cfg.num_layers):
                tokens = getattr(self, f"s{s}_block{i}")(tokens, (h, w), topk=cfg.attn_topk)
            x = tokens.reshape(b, h, w, d)
            if s < self.scale:
                if self.down:
                    x = getattr(self, f"merge{s}")(space_to_depth(x))
                else:
                    x = depth_to_space(getattr(self, f"expand{s}")(x))
        return self.proj_out(x).permute(0, 3, 1, 2)


def raster_causal_mask(h: int, w: int) -> np.ndarray:
    """(L, L) raster causal mask, True = may attend, the diagonal included
    (the raster path feeds inputs shifted by one position)."""
    return np.tril(np.ones((h * w, h * w), bool))


def checkerboard_masks(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(anchor map (H, W) bool: (i + j) even, attend mask (L, L): every
    token may attend every anchor)."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    anchor = (ii + jj) % 2 == 0
    flat = anchor.reshape(-1)
    return anchor, np.broadcast_to(flat[None, :], (h * w, h * w)).copy()


class EntroformerContext(nn.Module):
    """Masked-attention context model: per-position (μ, σ) of the latent
    from decoded positions and the hyper features.

    * 'checkerboard' — two weight-shared passes, neither masked: anchors
      from the hyper alone (latent input zero), then the non-anchors with
      the anchors' values in.  Decodes in 2 passes.
    * 'raster' — the raster-shifted latent under a causal mask (estimate
      only; the codec builds 'checkerboard').
    """

    def __init__(self, latent_channels: int, hyper_channels: int,
                 mode: str = "checkerboard",
                 cfg: EntroformerConfig = EntroformerConfig(dim=192, num_layers=4,
                                                            num_heads=6, dim_head=32),
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("checkerboard", "raster"):
            raise ValueError(f"unknown EntroformerContext mode {mode!r}")
        g = generator
        self.latent_channels, self.mode, self.cfg = latent_channels, mode, cfg
        self.embed_y = _dense(latent_channels, cfg.dim, generator=g)
        self.embed_h = _dense(hyper_channels, cfg.dim, generator=g)
        self.blocks = nn.ModuleList(EntroformerBlock(cfg, generator=g)
                                    for _ in range(cfg.num_layers))
        self.head = _dense(cfg.dim, 2 * latent_channels, generator=g)

    def embed_hyper(self, hyper: torch.Tensor) -> torch.Tensor:
        """NCHW hyper features → (B, H·W, D) embedded tokens: the prefix the
        two checkerboard passes share."""
        b, _, h, w = hyper.shape
        return self.embed_h(hyper.permute(0, 2, 3, 1)).reshape(b, h * w, self.cfg.dim)

    def run(self, y_in: torch.Tensor, hyper: Optional[torch.Tensor],
            mask: Optional[torch.Tensor], h_emb: Optional[torch.Tensor] = None):
        """One pass (the JAX module's ``_run``): NCHW latent input and hyper
        (or its ``embed_hyper`` tokens) → (μ, σ), each NCHW."""
        b, c, h, w = y_in.shape
        if h_emb is None:
            h_emb = self.embed_hyper(hyper)
        tok = self.embed_y(y_in.permute(0, 2, 3, 1).reshape(b, h * w, c)) + h_emb
        for blk in self.blocks:
            tok = blk(tok, (h, w), mask=mask, topk=self.cfg.attn_topk)
        out = self.head(tok).reshape(b, h, w, 2 * c).permute(0, 3, 1, 2)
        mu, log_sigma = out.chunk(2, dim=1)
        return mu, torch.exp(log_sigma)

    def forward(self, y_hat: torch.Tensor, hyper: torch.Tensor):
        """y_hat (B, C, H, W) quantized latent, hyper (B, Ch, H, W) → (μ, σ)."""
        b, c, h, w = y_hat.shape
        if self.mode == "raster":
            flat = y_hat.permute(0, 2, 3, 1).reshape(b, h * w, c)
            shifted = torch.cat([flat.new_zeros(b, 1, c), flat[:, :-1]], dim=1)
            shifted = shifted.reshape(b, h, w, c).permute(0, 3, 1, 2)
            mask = torch.from_numpy(raster_causal_mask(h, w)).to(y_hat.device)
            return self.run(shifted, hyper, mask)
        anchor = anchor_map(h, w, y_hat)
        mu1, s1 = self.run(torch.zeros_like(y_hat), hyper, None)
        mu2, s2 = self.run(y_hat * anchor, hyper, None)
        return anchor * mu1 + (1 - anchor) * mu2, anchor * s1 + (1 - anchor) * s2


def anchor_map(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """The checkerboard's anchors as a (1, 1, H, W) 0/1 tensor of ``like``'s
    dtype and device."""
    a = torch.from_numpy(checkerboard_masks(h, w)[0])
    return a.to(device=like.device, dtype=like.dtype)[None, None]


__all__ = [
    "EntroformerAttention",
    "EntroformerBlock",
    "EntroformerConfig",
    "EntroformerContext",
    "TransHyperScale",
    "anchor_map",
    "checkerboard_masks",
    "raster_causal_mask",
    "relative_position_buckets",
]
