"""Convolutions with the JAX package's padding arithmetic and inits, NCHW.

Counterpart of the plain semantics of ``lic_tpu/layers/conv.py``:

* ``Conv2d`` takes ``padding`` as an int (symmetric) or a torch
  ``ZeroPad2d`` 4-tuple ``(left, right, top, bottom)``, so the reference's
  asymmetric ``(1, 2, 1, 2)`` down-padding transcribes directly.
* ``ConvTranspose2d`` is ``F.conv_transpose2d``; its weight is stored in
  torch's ``(in, out, k, k)`` layout, related to the JAX kernel by
  ``W_t[in, out, a, b] = kernel[k-1-a, k-1-b, in, out]``
  (``lic_tpu/layers/conv.py:514-517``; see ``utils.params``).

The TPU lowering switches of the JAX module (space-to-depth, polyphase and
subpel deconvs, stencils, im2col, 1x1-as-matmul) have no counterpart: on
the card every one of them is one cuDNN convolution.  The 5x5 stride-2
slot stays a plain convolution until its hand kernel lands (ROADMAP B3).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

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
    fan-in LeCun truncated-normal init (``conv.py:40-43``), zero bias."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Pad = 0,
        bias: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        variance_scaling_(self.weight, 1.0, in_channels * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.padding, int):
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return F.conv2d(F.pad(x, self.padding), self.weight, self.bias, self.stride)


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
    select the ``ConvGenerator`` head's init (``syntax.py:107-114``).
    The weight is torch's ``(out, in)``: the transpose of flax's kernel."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        kernel_scale: float = 1.0,
        fan_avg: bool = False,
        bias_std: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        fan = (in_features + out_features) / 2 if fan_avg else in_features
        variance_scaling_(self.weight, kernel_scale, fan, generator)
        self.bias = nn.Parameter(torch.zeros(out_features))
        if bias_std:
            with torch.no_grad():
                nn.init.normal_(self.bias, 0.0, bias_std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``lic_tpu/layers/blocks.py:32-34``."""
    return F.gelu(x)
