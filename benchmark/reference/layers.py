"""Plain layers of the reference codecs.

Frozen copy of ``lic_tpu_torch/layers/{conv,conv_direct,gdn,blocks,swin,
win_attention,window_attn}.py`` and ``lic_tpu_torch/ops/bounds.py`` at
commit a087453, kept to what ``source_net`` and ``net_unet_ha_hs_dec``
use.  Where the program sends a call to kernel B2 (GDN), B3 (5x5 stride-2
conv), B4/B5 (window attention) or B6 (stride-1 conv), this module runs
the plain version of that kernel: ``F.conv2d``, the GDN norm as a matmul,
the window attention as batched matmuls and a softmax.  Parameter names
and layouts are the program's, so one state dict loads into both.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Pad = Union[int, Tuple[int, int, int, int]]
LEAKY_SLOPE = 0.01


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``where(x >= 0, x, slope·x)``: its gradient at 0 is 1."""
    return torch.where(x >= 0, x, x * slope)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` whose gradient passes where ``x >= bound`` or the
    gradient is negative."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LowerBound.apply(x, bound)
    return torch.clamp(x, min=bound)


class NonNegativeParametrizer:
    """``lower_bound(x)**2 - ped``, ``ped = offset**2``."""

    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2 ** -18):
        self.pedestal = reparam_offset ** 2
        self.bound = (float(minimum) + self.pedestal) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        """The stored value whose parametrized value is ``x``."""
        return torch.sqrt(torch.clamp(x + self.pedestal, min=self.pedestal))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return lower_bound(x, self.bound) ** 2 - self.pedestal


class Conv2d(nn.Module):
    """Conv with an int (symmetric) or ``(left, right, top, bottom)``
    padding; ``fused_act`` after the bias, then ``residual``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: Pad = 0, bias: bool = True, *,
                 fused_act: Optional[str] = None, groups: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.fused_act, self.groups = stride, padding, fused_act, groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (x.device.type == "cpu" and self.stride > 1 and self.weight.shape[-1] == 1
                and self.padding == 0):
            # the same product on the subsampled map: the CPU's (oneDNN)
            # backward of a strided 1x1 on a 3-channel channels_last input
            # corrupts the heap (torch 2.13)
            s = self.stride
            y = F.conv2d(x[:, :, ::s, ::s], self.weight, self.bias, groups=self.groups)
        elif isinstance(self.padding, int):
            y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding, groups=self.groups)
        else:
            y = F.conv2d(F.pad(x, self.padding), self.weight, self.bias, self.stride,
                         groups=self.groups)
        if self.fused_act == "leaky_relu":
            y = leaky_relu(y)
        return y if residual is None else y + residual


def DepthwiseConv2d(channels: int) -> Conv2d:
    return Conv2d(channels, channels, 3, 1, 1, groups=channels)


class SubpelConv2d(nn.Module):
    """3x3 conv to ``out·r²`` channels, then pixel shuffle."""

    def __init__(self, in_channels: int, out_channels: int, r: int = 2):
        super().__init__()
        self.r = r
        self.weight = nn.Parameter(torch.empty(out_channels * r * r, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels * r * r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(F.conv2d(x, self.weight, self.bias, padding=1), self.r)


class ConvTranspose2d(nn.Module):
    """``F.conv_transpose2d``; the weight is torch's (in, out, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 stride: int = 2, padding: int = 2, output_padding: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                  self.output_padding)


class Linear(nn.Module):
    """``F.linear`` with torch's (out, in) weight."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class GDN(nn.Module):
    """``y = x / sqrt(β + Γx²)``, or ``x · sqrt(β + Γx²)`` when
    ``inverse``; β and Γ stored in ``NonNegativeParametrizer`` space."""

    def __init__(self, num_features: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self._beta_rp = NonNegativeParametrizer(minimum=1e-6)
        self._gamma_rp = NonNegativeParametrizer()
        c = num_features
        self.beta = nn.Parameter(torch.empty(c))
        self.gamma = nn.Parameter(torch.empty(c, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self._gamma_rp(self.gamma), self._beta_rp(self.beta)
        x2d = x.permute(0, 2, 3, 1)
        norm = (x2d * x2d) @ gamma.t() + beta
        y = x2d * torch.sqrt(norm) if self.inverse else x2d / torch.sqrt(norm)
        return y.permute(0, 3, 1, 2)


def IGDN(num_features: int) -> GDN:
    return GDN(num_features, inverse=True)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, features: Optional[int] = None):
        super().__init__()
        n = features or in_channels
        self.conv1 = Conv2d(in_channels, n, 3, 1, 1, fused_act="leaky_relu")
        self.conv2 = Conv2d(n, n, 3, 1, 1, fused_act="leaky_relu")
        self.skip = Conv2d(in_channels, n, 1) if n != in_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.conv2(self.conv1(x), residual=identity)


ResidualBlock3x3 = ResidualBlock


class ResidualBlock3_5(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        n = in_channels
        self.conv1 = Conv2d(n, n, 3, 1, 1, fused_act="leaky_relu")
        self.conv2 = Conv2d(n, n, 5, 1, 2, fused_act="leaky_relu")
        self.conv3 = Conv2d(n, n, 3, 1, 1, fused_act="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(self.conv2(self.conv1(x)), residual=x)


class ResidualBlock5x5(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 5, 1, 2, fused_act="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, residual=x)


class ResidualUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        n = features
        self.conv1 = Conv2d(n, n // 2, 1)
        self.conv2 = Conv2d(n // 2, n // 2, 3, 1, 1)
        self.conv3 = Conv2d(n // 2, n, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv2(torch.relu(self.conv1(x))))
        return torch.relu(self.conv3(out) + x)


class ResidualBottleneck(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        n = features
        self.conv1 = Conv2d(n, n // 2, 1)
        self.conv2 = Conv2d(n // 2, n // 2, 3, 1, 1)
        self.conv3 = Conv2d(n // 2, n, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv3(gelu(self.conv2(gelu(self.conv1(x)))))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, fused_act="leaky_relu")
        self.conv2 = Conv2d(features, features, 3, 1, 1)
        self.gdn = GDN(features)
        self.skip = (Conv2d(in_channels, features, 1, stride)
                     if stride != 1 or in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        return self.gdn(self.conv2(self.conv1(x))) + identity


class AttentionBlock(nn.Module):
    """``a · σ(b) + x``; ``b_input`` replaces x on the b branch."""

    def __init__(self, features: int):
        super().__init__()
        for i in range(6):
            self.add_module(f"ru{i}", ResidualUnit(features))
        self.conv = Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, b_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.ru2(self.ru1(self.ru0(x)))
        b = self.conv(self.ru5(self.ru4(self.ru3(x if b_input is None else b_input))))
        return a * torch.sigmoid(b) + x


# ---------------------------------------------------------------- Swin (SWAtten)

_LN_EPS = 1e-6


def _wmsa_shift_mask(h_windows: int, w_windows: int, p: int, shift: int) -> np.ndarray:
    m = np.zeros((h_windows, w_windows, p, p, p, p), dtype=bool)
    s = p - shift
    m[-1, :, :s, :, s:, :] = True
    m[-1, :, s:, :, :s, :] = True
    m[:, -1, :, :s, :, s:] = True
    m[:, -1, :, s:, :, :s] = True
    m = m.reshape(h_windows * w_windows, p * p, p * p)
    return np.where(m, -np.inf, 0.0).astype(np.float32)


def _wmsa_pad_mask(h: int, w: int, hp: int, wp: int, ws: int, shifted: bool) -> np.ndarray:
    pad = np.zeros((hp, wp), dtype=bool)
    pad[h:, :] = True
    pad[:, w:] = True
    if shifted:
        pad = np.roll(pad, (-(ws // 2), -(ws // 2)), axis=(0, 1))
    f = pad.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(f[:, :, None] ^ f[:, None, :], -np.inf, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _wmsa_mask(h, w, ws, shifted, device) -> Optional[torch.Tensor]:
    hp, wp = h + (-h) % ws, w + (-w) % ws
    m = _wmsa_shift_mask(hp // ws, wp // ws, ws, ws // 2) if shifted else None
    if (hp, wp) != (h, w):
        pm = _wmsa_pad_mask(h, w, hp, wp, ws, shifted)
        m = pm if m is None else m + pm
    return None if m is None else torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=8)
def _wmsa_rel_index(ws: int, device):
    cord = np.array([[i, j] for i in range(ws) for j in range(ws)])
    rel = torch.from_numpy(cord[:, None, :] - cord[None, :, :] + ws - 1).to(device)
    return rel[..., 0], rel[..., 1]


class WMSA(nn.Module):
    """W/SW-MSA on an NHWC map (B, H, W, C)."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 block_type: str = "W"):
        super().__init__()
        ws = window_size
        self.head_dim, self.window_size, self.shifted = head_dim, ws, block_type == "SW"
        self.n_heads = input_dim // head_dim
        self.embedding_layer = Linear(input_dim, 3 * input_dim)
        self.relative_position_params = nn.Parameter(torch.empty(2 * ws - 1, 2 * ws - 1,
                                                                 self.n_heads))
        self.linear = Linear(input_dim, output_dim)

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
        q, k, v = qkv.unbind(3)
        sim = torch.einsum("bwphc,bwqhc->bhwpq", q, k) * hd ** -0.5
        iy, ix = _wmsa_rel_index(ws, x.device)
        rel = self.relative_position_params[iy, ix]
        sim = sim + rel.permute(2, 0, 1)[None, :, None]
        mask = _wmsa_mask(h, w, ws, self.shifted, x.device)
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
    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 block_type: str = "W"):
        super().__init__()
        self.ln1 = nn.LayerNorm(input_dim, eps=_LN_EPS)
        self.msa = WMSA(input_dim, input_dim, head_dim, window_size, block_type)
        self.ln2 = nn.LayerNorm(input_dim, eps=_LN_EPS)
        self.mlp_fc1 = Linear(input_dim, 4 * input_dim)
        self.mlp_fc2 = Linear(4 * input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.msa(self.ln1(x))
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.ln2(x))))


class SwinBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int):
        super().__init__()
        self.block_1 = SwinTransformerBlock(input_dim, output_dim, head_dim, window_size, "W")
        self.block_2 = SwinTransformerBlock(output_dim, output_dim, head_dim, window_size, "SW")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.block_1(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)


class SWAtten(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, head_dim: int, window_size: int,
                 inter_dim: int = 192):
        super().__init__()
        n = inter_dim
        self.in_conv = Conv2d(input_dim, n, 1)
        self.non_local_block = SwinBlock(n, n, head_dim, window_size)
        self.gate = AttentionBlock(n)
        self.out_conv = Conv2d(n, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        return self.out_conv(self.gate(x, b_input=self.non_local_block(x)))


# ------------------------------------------------- window attention (B4/B5's math)

def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _swin_shift_mask(h: int, w: int, ws: int, shift: int, pad_b: int, pad_r: int) -> np.ndarray:
    hp, wp = h + pad_b, w + pad_r
    img_mask = np.zeros((1, hp, wp, 1), np.float32)
    if shift > 0:
        slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
        cnt = 0
        for hs in slices:
            for wsl in slices:
                img_mask[:, hs, wsl, :] = cnt
                cnt += 1
    if pad_b or pad_r:
        pad = np.zeros((1, hp, wp, 1), np.float32)
        pad[:, h:, :, :] = 1.0
        pad[:, :, w:, :] = 1.0
        if shift > 0:
            pad = np.roll(pad, (-shift, -shift), axis=(1, 2))
        img_mask = img_mask + 100.0 * pad
    m = img_mask.reshape(1, hp // ws, ws, wp // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _shift_mask(h, w, ws, shift, pad_b, pad_r, device) -> Optional[torch.Tensor]:
    if not (shift > 0 or pad_b or pad_r):
        return None
    return torch.from_numpy(_swin_shift_mask(h, w, ws, shift, pad_b, pad_r)).to(device)


@functools.lru_cache(maxsize=8)
def _rel_index(ws: int, device) -> torch.Tensor:
    return torch.from_numpy(_relative_position_index(ws).reshape(-1)).to(device)


def window_attention_plain(qkv, rel, mask, ws: int, nh: int) -> torch.Tensor:
    """W-MSA core: qkv (B, Hp, Wp, 3C) → (B, Hp, Wp, C)."""
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    hd = c // nh
    win = qkv.reshape(b, hp // ws, ws, wp // ws, ws, c3).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(-1, n, c3)
    heads = lambda t: t.reshape(-1, n, nh, hd).transpose(1, 2)
    q = heads(win[..., :c] * hd ** -0.5)
    k, v = heads(win[..., c: 2 * c]), heads(win[..., 2 * c:])
    logits = q @ k.transpose(-1, -2) + rel[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b, nw, nh, n, n) + mask.to(logits.dtype)[None, :, None])
        logits = logits.reshape(-1, nh, n, n)
    o = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
    o = o.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, hp, wp, c)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        ws = window_size
        self.window_size, self.num_heads = ws, num_heads
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2,
                                                                     num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        ws, nh = self.window_size, self.num_heads
        n = ws * ws
        idx = _rel_index(ws, x.device)
        rel = self.relative_position_bias_table[idx].reshape(n, n, nh).permute(2, 0, 1)
        return self.proj(window_attention_plain(self.qkv(x), rel, mask, ws, nh))


class WinBasedAttention(nn.Module):
    """Pad, cyclic shift, W-MSA with the −100 shift/pad mask, roll back,
    crop, residual."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8, shift_size: int = 0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, window_size, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        ws, ss = self.window_size, self.shift_size
        pad_b, pad_r = (-h) % ws, (-w) % ws
        t = x.permute(0, 2, 3, 1)
        if pad_b or pad_r:
            t = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
        if ss > 0:
            t = torch.roll(t, shifts=(-ss, -ss), dims=(1, 2))
        t = self.attn(t, _shift_mask(h, w, ws, ss, pad_b, pad_r, x.device))
        if ss > 0:
            t = torch.roll(t, shifts=(ss, ss), dims=(1, 2))
        return x + t[:, :h, :w].permute(0, 3, 1, 2)


class WinNoShiftAttention(nn.Module):
    """``a · σ(b) + x`` (shifts where ``shift_size > 0``, as the reference)."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8, shift_size: int = 0):
        super().__init__()
        wba = lambda: WinBasedAttention(dim, num_heads, window_size, shift_size)
        self.conv_a = nn.ModuleList(ResidualBlock(dim) for _ in range(3))
        self.wba0 = wba()
        self.c1x1 = Conv2d(dim, dim, 1)
        self.wba1 = wba()
        self.rb1 = ResidualBlock(dim)
        self.c3x3 = Conv2d(dim, dim, 3, 1, 1)
        self.wba2 = wba()
        self.rb2 = ResidualBlock(dim)
        self.c7x7 = Conv2d(dim, dim, 7, 1, 3)
        self.wba3 = wba()
        self.rb3 = ResidualBlock(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x
        for blk in self.conv_a:
            a = blk(a)
        b = x
        for layer in (self.wba0, self.c1x1, self.wba1, self.rb1, self.c3x3,
                      self.wba2, self.rb2, self.c7x7, self.wba3, self.rb3):
            b = layer(b)
        return a * torch.sigmoid(b) + x
