"""WMSA-family Swin blocks and the ChARM slice attention ``SWAtten``
(counterpart of ``lic_tpu/layers/swin.py:23-231``), NCHW in, NCHW out.

* ``WMSA`` — W/SW-MSA over windows of ``ws × ws`` with a (2ws-1, 2ws-1, nh)
  relative-position table indexed by its own (dy, dx) pair (not
  ``WindowAttention``'s flattened ((2ws-1)², nh) table), the SW variant
  rolled by ``ws // 2``, and −∞ masks: the shift mask touches only the
  last window row and column; pad tokens (maps that are not multiples of
  the window) are hidden from real ones, pad↔pad stays 0 so no softmax row
  is all −∞.  The output ``linear`` is zero-init.
* ``SwinTransformerBlock`` — LN → WMSA → +res; LN → MLP (4×, exact GELU,
  zero-init ``mlp_fc2``) → +res.  flax ``LayerNorm``: ε = 1e-6.
* ``SwinBlock`` — a W block, then an SW block.
* ``SWAtten`` — 1×1 in → ``AttentionBlock`` gate whose b branch sees the
  ``SwinBlock`` features → 1×1 out.

The JAX package has no Pallas kernel for WMSA: these plain torch ops are
its port, on the CPU and on the card alike.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import AttentionBlock
from .conv import Conv2d, Linear, gelu

_TABLE_STD = 0.02
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def wmsa_shift_mask(h_windows: int, w_windows: int, p: int, shift: int) -> np.ndarray:
    """The SW block's additive mask (nW, p², p²): −∞ between the parts of
    the last window row/column that the roll brought together, else 0."""
    m = np.zeros((h_windows, w_windows, p, p, p, p), dtype=bool)
    s = p - shift
    m[-1, :, :s, :, s:, :] = True
    m[-1, :, s:, :, :s, :] = True
    m[:, -1, :, :s, :, s:] = True
    m[:, -1, :, s:, :, :s] = True
    m = m.reshape(h_windows * w_windows, p * p, p * p)
    return np.where(m, -np.inf, 0.0).astype(np.float32)


def wmsa_pad_mask(h: int, w: int, hp: int, wp: int, ws: int, shifted: bool) -> np.ndarray:
    """Additive mask (nW, p², p²) hiding the bottom/right pad tokens from
    the real ones (−∞ between a pad and a real token)."""
    pad = np.zeros((hp, wp), dtype=bool)
    pad[h:, :] = True
    pad[:, w:] = True
    if shifted:
        pad = np.roll(pad, (-(ws // 2), -(ws // 2)), axis=(0, 1))
    f = pad.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(f[:, :, None] ^ f[:, None, :], -np.inf, 0.0).astype(np.float32)


def wmsa_relative_index(ws: int) -> np.ndarray:
    """(p², p², 2) index into the (2ws-1, 2ws-1) table."""
    cord = np.array([[i, j] for i in range(ws) for j in range(ws)])
    return cord[:, None, :] - cord[None, :, :] + ws - 1


@functools.lru_cache(maxsize=32)
def _mask(h, w, ws, shifted, device) -> Optional[torch.Tensor]:
    hp, wp = h + (-h) % ws, w + (-w) % ws
    m = wmsa_shift_mask(hp // ws, wp // ws, ws, ws // 2) if shifted else None
    if (hp, wp) != (h, w):
        pm = wmsa_pad_mask(h, w, hp, wp, ws, shifted)
        m = pm if m is None else m + pm
    return None if m is None else torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=8)
def _rel_index(ws: int, device):
    rel = torch.from_numpy(wmsa_relative_index(ws)).to(device)
    return rel[..., 0], rel[..., 1]


class WMSA(nn.Module):
    """W/SW-MSA on an NHWC map (B, H, W, C)."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 block_type: str = "W", *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if block_type not in ("W", "SW"):
            raise ValueError(f"block_type must be 'W' or 'SW', got {block_type!r}")
        ws = window_size
        self.head_dim, self.window_size, self.shifted = head_dim, ws, block_type == "SW"
        self.n_heads = input_dim // head_dim
        self.embedding_layer = Linear(input_dim, 3 * input_dim, generator=generator)
        table = torch.empty(2 * ws - 1, 2 * ws - 1, self.n_heads)
        nn.init.trunc_normal_(table, 0.0, _TABLE_STD, -2 * _TABLE_STD, 2 * _TABLE_STD,
                              generator=generator)
        self.relative_position_params = nn.Parameter(table)
        self.linear = Linear(input_dim, output_dim, generator=generator)
        nn.init.zeros_(self.linear.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws, nh, hd = self.window_size, self.n_heads, self.head_dim
        b, h, w, c = x.shape
        pad_b, pad_r = (-h) % ws, (-w) % ws
        hp, wp = h + pad_b, w + pad_r
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if self.shifted:
            x = torch.roll(x, shifts=(-(ws // 2), -(ws // 2)), dims=(1, 2))
        nwh, nww, n = hp // ws, wp // ws, ws * ws
        xw = x.reshape(b, nwh, ws, nww, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, n, c)
        qkv = self.embedding_layer(xw).reshape(b, nwh * nww, n, 3, nh, hd)
        q, k, v = qkv.unbind(3)  # (b, nW, n, nh, hd)
        sim = torch.einsum("bwphc,bwqhc->bhwpq", q, k) * hd ** -0.5
        iy, ix = _rel_index(ws, x.device)
        rel = self.relative_position_params[iy, ix]  # (n, n, nh)
        sim = sim + rel.permute(2, 0, 1)[None, :, None]
        mask = _mask(h, w, ws, self.shifted, x.device)
        if mask is not None:
            sim = sim + mask.to(sim.dtype)[None, None]
        out = torch.einsum("bhwpq,bwqhc->bwphc", torch.softmax(sim, dim=-1), v)
        out = self.linear(out.reshape(b, nwh * nww, n, nh * hd))
        out = out.reshape(b, nwh, nww, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hp, wp, -1)
        if self.shifted:
            out = torch.roll(out, shifts=(ws // 2, ws // 2), dims=(1, 2))
        return out[:, :h, :w] if pad_b or pad_r else out


class SwinTransformerBlock(nn.Module):
    """NHWC in, NHWC out."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 block_type: str = "W", *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ln1 = nn.LayerNorm(input_dim, eps=_LN_EPS)
        self.msa = WMSA(input_dim, input_dim, head_dim, window_size, block_type, generator=g)
        self.ln2 = nn.LayerNorm(input_dim, eps=_LN_EPS)
        self.mlp_fc1 = Linear(input_dim, 4 * input_dim, generator=g)
        self.mlp_fc2 = Linear(4 * input_dim, output_dim, generator=g)
        nn.init.zeros_(self.mlp_fc2.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.msa(self.ln1(x))
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.ln2(x))))


class SwinBlock(nn.Module):
    """A W block then an SW block, NCHW in and out (NHWC inside)."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.block_1 = SwinTransformerBlock(input_dim, output_dim, head_dim, window_size,
                                            "W", generator=g)
        self.block_2 = SwinTransformerBlock(output_dim, output_dim, head_dim, window_size,
                                            "SW", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.block_2(self.block_1(x.permute(0, 2, 3, 1)))
        return t.permute(0, 3, 1, 2)


class SWAtten(nn.Module):
    """1×1 in → gate(x, b = SwinBlock(x)) → 1×1 out (``inter_dim`` wide)."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 inter_dim: int = 192, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, n = generator, inter_dim
        self.in_conv = Conv2d(input_dim, n, 1, generator=g)
        self.non_local_block = SwinBlock(n, n, head_dim, window_size, generator=g)
        self.gate = AttentionBlock(n, generator=g)
        self.out_conv = Conv2d(n, output_dim, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        return self.out_conv(self.gate(x, b_input=self.non_local_block(x)))
