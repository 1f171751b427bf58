"""HAN post-processing head (Holistic Attention Network, upsampler
removed), NCHW: counterpart of ``lic_tpu/models/han.py``.

RCAB channel-attention blocks in residual groups, layer attention (LAM)
across the group outputs, channel-spatial attention (CSAM) through a 3-D
conv over the (C, H, W) volume, and the DIV2K mean shift; 4 groups × 8
blocks, or 6 × 12 at ``is_high``, of 64 features.  The output is 64
feature channels; the codec maps them to RGB with a second per-image
generated 1x1 conv (``CodecModel._decode_tail``).

The 64-channel convs lie outside kernel B6's gate (128 < C_in <= 192) and
the head conv's 3 input channels outside B3's, in the JAX package as here,
so every HAN conv is ``F.conv2d`` (cuDNN on the card).  CSAM's 3×3×3
single-channel conv is ``F.conv3d`` on the volume: the JAX package lowers
the same cross-correlation as three channel-shifted depthwise stencils
for the TPU's layout (``lic_tpu/models/han.py:115-150``), which a GPU
does not need.

JAX's nested ``remat`` becomes ``torch.utils.checkpoint`` around each
RCAB, in training mode with gradients on only: HAN runs at full image
resolution, and a group's RCABs would otherwise keep several (B, 64, H,
W) temporaries each for the backward.

Parameter names follow the flax tree (``group0/rcab3/ca/fc0``, ``la/gamma``,
``csa/conv``), so ``utils.params`` carries them as it carries the rest
of the model.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..layers import Conv2d

DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def mean_shift(x: torch.Tensor, sign: int, rgb_range: float = 1.0) -> torch.Tensor:
    """x ± the DIV2K mean per RGB channel (the reference's frozen
    ``MeanShift`` conv as a fixed shift)."""
    mean = torch.tensor(DIV2K_RGB_MEAN, dtype=x.dtype, device=x.device) * rgb_range
    return x + sign * mean[None, :, None, None]


def _zero_conv(cin: int, cout: int, generator) -> Conv2d:
    """3×3 conv, padding 1, with a zero kernel (flax ``zeros_init``)."""
    conv = Conv2d(cin, cout, 3, 1, 1, generator=generator)
    nn.init.zeros_(conv.weight)
    return conv


class CALayer(nn.Module):
    """Squeeze-excite channel attention."""

    def __init__(self, channels: int, reduction: int = 16, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = Conv2d(channels, channels // reduction, 1, generator=generator)
        self.fc1 = Conv2d(channels // reduction, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3), keepdim=True)
        y = self.fc1(torch.relu(self.fc0(y)))
        return x * torch.sigmoid(y)


class RCAB(nn.Module):
    """conv3 → ReLU → conv3 (zero init) → CA, residual."""

    def __init__(self, features: int, reduction: int = 16, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv2d(features, features, 3, 1, 1, generator=generator)
        self.c1 = _zero_conv(features, features, generator)
        self.ca = CALayer(features, reduction, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ca(self.c1(torch.relu(self.c0(x))))


class ResidualGroup(nn.Module):
    """n × RCAB + conv3 (zero init), residual.  With ``remat`` each RCAB
    runs under ``torch.utils.checkpoint`` when the module trains with
    gradients on: only the block boundaries stay for the backward."""

    def __init__(self, features: int, n_resblocks: int, reduction: int = 16,
                 remat: bool = False, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_resblocks = n_resblocks
        self.remat = remat
        for i in range(n_resblocks):
            self.add_module(f"rcab{i}", RCAB(features, reduction, generator=generator))
        self.tail = _zero_conv(features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        r = x
        for i in range(self.n_resblocks):
            block = getattr(self, f"rcab{i}")
            r = checkpoint(block, r, use_reentrant=False) if remat else block(r)
        return x + self.tail(r)


class LAMModule(nn.Module):
    """Layer attention across the N stacked group outputs:
    (B, N, C, H, W) → (B, N·C, H, W), N-major channels as the reference's
    ``view(B, N·C, H, W)``."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c, h, w = x.shape
        flat = x.reshape(b, n, -1)
        energy = torch.bmm(flat, flat.transpose(1, 2))
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = torch.bmm(attn, flat).reshape(x.shape)
        out = self.gamma * out + x
        return out.reshape(b, n * c, h, w).contiguous(memory_format=torch.channels_last)


class CSAMModule(nn.Module):
    """Channel-spatial attention: a 1-channel 3×3×3 conv (padding 1 on all
    of C, H and W) over the (C, H, W) volume, sigmoid, scaled by γ,
    ``x·g + x``.  ``conv`` is the (D, H, W) taps of the flax (3, 3, 3, 1,
    1) kernel (``utils.params`` drops and restores the two unit axes: a
    5-D parameter cannot take the model's ``channels_last``); its init is
    flax's ``xavier_uniform`` (fan in = fan out = 27)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        bound = math.sqrt(6.0 / (27 + 27))
        self.conv = nn.Parameter(torch.empty(3, 3, 3))
        with torch.no_grad():
            self.conv.uniform_(-bound, bound, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.conv.to(x.dtype)[None, None]  # (1, 1, 3, 3, 3)
        g = F.conv3d(x.contiguous()[:, None], kernel, self.bias.to(x.dtype), padding=1)[:, 0]
        g = self.gamma * torch.sigmoid(g)
        return x * g + x


class HANHead(nn.Module):
    """sub_mean → head conv → residual groups (+ ``body_tail``) with LAM
    over the stage outputs, newest first, and CSAM on the last → fuse →
    + head features.  Input (B, 3, H, W), output (B, 64, H, W)."""

    def __init__(self, is_high: bool = False, n_feats: int = 64, reduction: int = 32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.n_resgroups = 6 if is_high else 4
        n_resblocks = 12 if is_high else 8
        self.head = Conv2d(3, n_feats, 3, 1, 1, generator=g)
        for i in range(self.n_resgroups):
            self.add_module(f"group{i}", ResidualGroup(n_feats, n_resblocks, reduction,
                                                       remat=True, generator=g))
        self.body_tail = Conv2d(n_feats, n_feats, 3, 1, 1, generator=g)
        self.la = LAMModule()
        self.last_conv = Conv2d(n_feats * (self.n_resgroups + 1), n_feats, 3, 1, 1,
                                generator=g)
        self.csa = CSAMModule(generator=g)
        self.last = Conv2d(2 * n_feats, n_feats, 3, 1, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(mean_shift(x, sign=-1))
        res, stages = x, []
        for i in range(self.n_resgroups):
            res = getattr(self, f"group{i}")(res)
            stages.append(res)
        res = self.body_tail(res)
        stages.append(res)
        out2 = self.last_conv(self.la(torch.stack(stages[::-1], dim=1)))
        out1 = self.csa(res)
        fused = torch.cat([out1, out2], dim=1)
        return self.last(fused) + x
