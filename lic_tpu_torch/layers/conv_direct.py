"""Kernels B3 and B6 (``csrc/conv_direct.cu``): wrappers and plain versions.

* B3 ``conv5s2`` — ``ZeroPad2d(1, 2, 1, 2)`` + 5×5 stride-2 conv, replacing
  ``lic_tpu/layers/pallas_conv.py::conv5s2_pallas`` (and ``_v2``, the same
  function); plain version ``conv5s2_plain``.
* B6 ``convk_s1`` — stride-1 "same" k×k conv with the optional bias,
  LeakyReLU (slope 0.01) and residual epilogue, replacing
  ``lic_tpu/layers/pallas_conv_s1.py::convk_s1_pallas``; plain version
  ``convk_s1_plain``.

Tensors are NCHW in ``channels_last`` memory (the kernels read NHWC), fp32,
weights OIHW.  CPU tensors take the plain version; CUDA tensors launch the
kernel, built at first use; any other device, another memory format or
dtype raises (nothing is copied quietly).  The kernels are forward only: a
CUDA call that autograd would have to differentiate raises.  ``Conv2d``
sends its B3 and B6 slots here, under the JAX package's gates.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.build import CudaLibrary, check_cuda_inputs, check_launch

LEAKY_SLOPE = 0.01


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv_direct_launch.restype = ctypes.c_int
    lib.conv_direct_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )


library = CudaLibrary("conv_direct.cu", _bind)


def conv5s2_plain(x, weight, bias=None):
    """``F.pad`` (1, 2, 1, 2) + ``F.conv2d`` stride 2."""
    return F.conv2d(F.pad(x, (1, 2, 1, 2)), weight, bias, stride=2)


def convk_s1_plain(x, weight, bias=None, act=None, residual=None):
    """``F.conv2d`` with padding k//2, + bias, then LeakyReLU, then +
    residual (the order of ``_convk_s1_kernel``)."""
    y = F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)
    if act == "leaky_relu":
        y = F.leaky_relu(y, LEAKY_SLOPE)
    elif act is not None:
        raise ValueError(f"unknown act {act!r}")
    return y if residual is None else y + residual


def _channels_last(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: needs a channels_last NCHW tensor, got strides {t.stride()}")


def _launch(name, x, weight, bias, residual, stride, pad_t, pad_l, ho, wo, leaky):
    check_cuda_inputs(name, x, weight, bias, residual)
    _channels_last(name, x)
    b, cin, h, w = x.shape
    cout, wcin, k, k2 = weight.shape
    if wcin != cin or k != k2:
        raise ValueError(f"{name}: weight {tuple(weight.shape)} vs input channels {cin}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} vs {cout} channels")
    if residual is not None:
        _channels_last(name, residual)
        if tuple(residual.shape) != (b, cout, ho, wo):
            raise ValueError(f"{name}: residual {tuple(residual.shape)} vs output")
    w_hwio = weight.permute(2, 3, 1, 0).contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((b, cout, ho, wo), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    err = library().conv_direct_launch(
        x.data_ptr(), w_hwio.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        b, h, w, cin, ho, wo, cout, k, stride, pad_t, pad_l, int(leaky),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, name)
    return y


def conv5s2(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3: ``ZeroPad2d(1, 2, 1, 2)`` + 5×5 stride-2 conv (+ bias), even H, W."""
    if x.device.type == "cpu":
        return conv5s2_plain(x, weight, bias)
    h, w = x.shape[-2:]
    if weight.shape[-1] != 5 or h % 2 or w % 2:
        raise ValueError(f"conv5s2: 5x5 weight and even H, W needed, got "
                         f"{tuple(weight.shape)} on {h}x{w}")
    y = _launch("conv5s2", x, weight, bias, None, 2, 1, 1, h // 2, w // 2, False)
    conv5s2.launches += 1
    return y


conv5s2.launches = 0


def convk_s1(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6: stride-1 "same" k×k conv (k odd), then + bias, LeakyReLU if
    ``act == 'leaky_relu'``, then + ``residual``."""
    if x.device.type == "cpu":
        return convk_s1_plain(x, weight, bias, act, residual)
    if act not in (None, "leaky_relu"):
        raise ValueError(f"unknown act {act!r}")
    k = weight.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"convk_s1: odd kernel size needed, got {k}")
    h, w = x.shape[-2:]
    y = _launch("convk_s1", x, weight, bias, residual, 1, k // 2, k // 2, h, w,
                act == "leaky_relu")
    convk_s1.launches += 1
    return y


convk_s1.launches = 0
