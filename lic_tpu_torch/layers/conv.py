"""Convolutions with the JAX package's padding arithmetic and inits, NCHW.

Counterpart of the plain semantics of ``lic_tpu/layers/conv.py``:

* ``Conv2d`` takes ``padding`` as an int (symmetric) or a torch
  ``ZeroPad2d`` 4-tuple ``(left, right, top, bottom)``, so the reference's
  asymmetric ``(1, 2, 1, 2)`` down-padding transcribes directly.
* ``ConvTranspose2d`` is ``F.conv_transpose2d``; its weight is stored in
  torch's ``(in, out, k, k)`` layout, related to the JAX kernel by
  ``W_t[in, out, a, b] = kernel[k-1-a, k-1-b, in, out]``
  (``lic_tpu/layers/conv.py:514-517``; see ``utils.params``).

``Conv2d`` sends two slots to hand-written kernels (``conv_direct``),
under exactly the JAX module's gates (``lic_tpu/layers/conv.py:434-458``):

* B3, ``conv5s2``: k=5, stride 2, padding ``(1, 2, 1, 2)``, C_in >= 128,
  even H and W;
* B6, ``convk_s1``: stride 1, k in {3, 5, 7}, 128 < C_in <= 192, padding
  k//2, with the bias, ``fused_act`` and an optional residual in its
  epilogue.

On a CPU tensor those wrappers run their plain versions.  A C_in that is
no multiple of 4 keeps its conv out of both slots (the kernels' TMA loads
need rows of whole 16 bytes), and so does a grouped conv.  Every other
conv, and the JAX module's other TPU lowerings (space-to-depth, polyphase
and subpel deconvs, stencils, im2col, 1x1-as-matmul), is ``F.conv2d`` /
``F.conv_transpose2d``: the JAX package runs them through XLA, not Pallas.

Also here: ``SubpelConv2d`` (3×3 conv + pixel shuffle, channels in torch's
``PixelShuffle`` order as the JAX module puts them,
``lic_tpu/layers/conv.py:605-609``) and ``DepthwiseConv2d`` (flax
``nn.Conv`` with ``feature_group_count = C``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .conv_direct import conv5s2, convk_s1, leaky_relu

Pad = Union[int, Tuple[int, int, int, int]]

# flax's truncated_normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(
    t: torch.Tensor,
    scale: float,
    fan: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """In-place ``flax.linen.initializers.variance_scaling(scale, ·,
    'truncated_normal')`` given the fan the flax mode selects."""
    std = math.sqrt(scale / fan) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


class Conv2d(nn.Module):
    """Conv with torch-style explicit padding and the JAX package's
    fan-in LeCun truncated-normal init (``conv.py:40-43``), zero bias;
    ``groups`` as ``F.conv2d``'s (the weight is (out, in/groups, k, k)).

    ``fused_act`` (None | ``'leaky_relu'``) is applied after the bias, in
    the B6 kernel's epilogue where that slot runs; ``forward``'s
    ``residual`` is added after it (``ResidualBlock``'s skip)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Pad = 0,
        bias: bool = True,
        *,
        fused_act: Optional[str] = None,
        groups: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if fused_act not in (None, "leaky_relu"):
            raise ValueError(f"unknown fused_act {fused_act!r}")
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.fused_act = fused_act
        self.groups = groups
        cin = in_channels // groups
        self.weight = nn.Parameter(torch.empty(out_channels, cin, k, k))
        variance_scaling_(self.weight, 1.0, cin * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def kernel_slot(self, x: torch.Tensor) -> Optional[str]:
        """``'conv5s2'`` (B3) or ``'convk_s1'`` (B6) where a call on ``x``
        takes that kernel's slot under the JAX gates, else None.  A grouped
        conv or a C_in that is no multiple of 4 takes neither."""
        k = self.weight.shape[-1]
        cin, h, w = x.shape[1:]
        if self.groups != 1 or cin % 4:
            return None
        if (k == 5 and self.stride == 2 and self.padding == (1, 2, 1, 2)
                and cin >= 128 and h % 2 == 0 and w % 2 == 0):
            return "conv5s2"
        if (self.stride == 1 and k in (3, 5, 7) and 128 < cin <= 192
                and self.padding == k // 2):
            return "convk_s1"
        return None

    def forward(
        self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        slot = self.kernel_slot(x)
        if slot == "convk_s1":
            return convk_s1(x, self.weight, self.bias, self.fused_act, residual)
        if slot == "conv5s2":
            y = conv5s2(x, self.weight, self.bias)
        elif (x.device.type == "cpu" and self.stride > 1 and self.weight.shape[-1] == 1
              and self.padding == 0):
            # a strided 1×1 is a 1×1 on the subsampled map; torch's CPU
            # (oneDNN) backward of the strided form on a channels_last input
            # of 3 channels corrupts the heap (torch 2.13)
            s = self.stride
            y = F.conv2d(x[:, :, ::s, ::s], self.weight, self.bias, groups=self.groups)
        elif isinstance(self.padding, int):
            y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                         groups=self.groups)
        else:
            y = F.conv2d(F.pad(x, self.padding), self.weight, self.bias, self.stride,
                         groups=self.groups)
        if self.fused_act == "leaky_relu":
            y = leaky_relu(y)
        return y if residual is None else y + residual


def DepthwiseConv2d(channels: int, *, generator: Optional[torch.Generator] = None) -> Conv2d:
    """Depthwise 3×3, padding 1, with bias: flax ``nn.Conv(C, (3, 3),
    padding=1, feature_group_count=C)``, whose default init is the same
    fan-in LeCun truncated normal (fan 9)."""
    return Conv2d(channels, channels, 3, 1, 1, groups=channels, generator=generator)


class SubpelConv2d(nn.Module):
    """3×3 conv (padding 1) to ``out_channels · r²``, then pixel shuffle:
    ``lic_tpu/layers/conv.py::SubpelConv2d``.  The JAX module orders the
    conv's channels c_out-major, then (r, r): torch's ``PixelShuffle``
    order, so ``F.pixel_shuffle`` is its shuffle.  The JAX module calls
    ``lax.conv`` itself, never a Pallas slot; so does this one."""

    def __init__(
        self, in_channels: int, out_channels: int, r: int = 2, *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.r = r
        self.weight = nn.Parameter(torch.empty(out_channels * r * r, in_channels, 3, 3))
        variance_scaling_(self.weight, 1.0, in_channels * 9, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels * r * r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, padding=1)
        return F.pixel_shuffle(y, self.r).contiguous(memory_format=torch.channels_last)


class ConvTranspose2d(nn.Module):
    """Torch-semantics transposed conv:
    ``out = (in - 1)·stride - 2·padding + kernel + output_padding``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 5,
        stride: int = 2,
        padding: int = 2,
        output_padding: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        # the JAX kernel is (k, k, in, out): its fan-in is k·k·in
        variance_scaling_(self.weight, 1.0, in_channels * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding,
        )


class Linear(nn.Module):
    """``flax.linen.Dense`` with its init: LeCun truncated normal (fan-in)
    kernel and zero bias unless ``kernel_scale``/``fan_avg``/``bias_std``
    select the ``ConvGenerator`` head's init (``syntax.py:107-114``);
    ``bias=False`` is ``use_bias=False``.  The weight is torch's
    ``(out, in)``: the transpose of flax's kernel."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        kernel_scale: float = 1.0,
        fan_avg: bool = False,
        bias_std: float = 0.0,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        fan = (in_features + out_features) / 2 if fan_avg else in_features
        variance_scaling_(self.weight, kernel_scale, fan, generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        if bias_std:
            with torch.no_grad():
                nn.init.normal_(self.bias, 0.0, bias_std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``lic_tpu/layers/blocks.py:32-34``."""
    return F.gelu(x)
