"""Kernels B3 and B6 (``csrc/conv_direct.cu``): wrappers and plain versions.

* B3 ``conv5s2`` — ``ZeroPad2d(1, 2, 1, 2)`` + 5×5 stride-2 conv, replacing
  ``lic_tpu/layers/pallas_conv.py::conv5s2_pallas`` (and ``_v2``, the same
  function); plain version ``conv5s2_plain``.
* B6 ``convk_s1`` — stride-1 "same" k×k conv with the optional bias,
  LeakyReLU (slope 0.01) and residual epilogue, replacing
  ``lic_tpu/layers/pallas_conv_s1.py::convk_s1_pallas``; plain version
  ``convk_s1_plain``.

Tensors are NCHW in ``channels_last`` memory (the kernels read NHWC), fp32
or bf16, weights OIHW.  The kernel computes in fp32: a bf16 call is widened
at the kernel boundary (exactly) and its output rounded back to bf16 — bf16
operands, an fp32 sum, a bf16 result, as the JAX package's bf16 convs.  CPU
tensors take the plain version; CUDA tensors launch the kernel, built at
first use; any other device, another memory format or dtype raises, and so
does a C_in that is no multiple of 4 (the kernel's TMA loads need 16-byte
rows; ``Conv2d`` keeps such convs out of the slots).  The kernels are
forward only: a CUDA call that autograd would have to differentiate raises.
``Conv2d`` sends its B3 and B6 slots here, under the JAX package's gates.

The kernel runs 3xTF32 on the tensor cores: each fp32 operand is split into
``hi = tf32(a)`` and ``lo = tf32(a - hi)`` (``tf32_split``), and a·b is
summed as hi·lo + lo·hi + hi·hi.  The weight's split is made here, once per
weight: ``prepacked`` keeps an OHWI ``(w_hi, w_lo)`` pair on the weight
tensor and rebuilds it when the weight changes in place (its version
counter) or moves (its ``data_ptr``).  An update through ``weight.data``
bypasses the version counter; update the parameter itself, as optimizers
and ``load_state_dict`` do.
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
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    lib.conv_direct_occupancy.restype = ctypes.c_int
    lib.conv_direct_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2


library = CudaLibrary("conv_direct.cu", _bind)

_EXP = 0x7F800000
_LOW13 = 0x1FFF  # the fp32 mantissa bits that TF32 drops


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10-bit mantissa, ties to even), as
    fp32 bits with the 13 low mantissa bits zero.  Signed zeros and
    subnormals round like any other value; ±inf stays; NaN becomes the
    canonical quiet NaN; a finite value beyond TF32's largest rounds to
    ±inf, as IEEE rounding does."""
    b = t.to(torch.float32).contiguous().view(torch.int32)
    r = (b + (0xFFF + ((b >> 13) & 1))) & ~_LOW13
    r = torch.where((b & _EXP) == _EXP, b, r).view(torch.float32)
    return torch.where(torch.isnan(r), float("nan"), r)


def tf32_split(t: torch.Tensor):
    """(hi, lo) with ``hi = tf32_round(t)`` and ``lo = tf32_round(t - hi)``:
    for finite t, ``|hi + lo - t| <= max(2**-22 |t|, 2**-137)`` (2**-137 is
    half the smallest TF32 subnormal, where lo is subnormal).  Where t is
    ±inf or NaN, hi carries it and lo is 0."""
    hi = tf32_round(t)
    lo = tf32_round(t.to(torch.float32) - hi)
    return hi, torch.where(torch.isfinite(t), lo, 0.0)


def pack_weight(weight: torch.Tensor):
    """OIHW weight → ``(w_hi, w_lo)``, each OHWI ``(C_out, k, k, C_in)``
    contiguous fp32: the layout the kernel's weight tensor maps read (each
    output channel's K = k·k·C_in contiguous)."""
    with torch.no_grad():
        return tf32_split(weight.detach().permute(0, 2, 3, 1).contiguous())


def prepacked(weight: torch.Tensor):
    """``pack_weight(weight)``, cached on the weight tensor; rebuilt when
    the weight changes in place or its storage, device or shape changes."""
    key = (weight._version, weight.data_ptr(), weight.device, tuple(weight.shape))
    cached = getattr(weight, "_tf32_prepack", None)
    if cached is None or cached[0] != key:
        cached = (key, *pack_weight(weight))
        weight._tf32_prepack = cached
    return cached[1], cached[2]


def occupancy() -> tuple:
    """(shared memory bytes per CTA, CTAs resident per SM) of the kernel,
    from the card's occupancy calculator (builds the library; needs CUDA)."""
    smem, ctas = ctypes.c_int(0), ctypes.c_int(0)
    check_launch(library().conv_direct_occupancy(ctypes.byref(smem), ctypes.byref(ctas)),
                 "conv_direct_occupancy")
    return smem.value, ctas.value


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
    if cin % 4:
        raise ValueError(f"{name}: C_in {cin} is no multiple of 4 (the kernel's TMA "
                         "loads need rows of whole 16 bytes)")
    if residual is not None:
        _channels_last(name, residual)
        if tuple(residual.shape) != (b, cout, ho, wo):
            raise ValueError(f"{name}: residual {tuple(residual.shape)} vs output")
    w_hi, w_lo = prepacked(weight)  # the split widens a bf16 weight
    dtype = x.dtype
    x = x.float()  # keeps channels_last
    bias = None if bias is None else bias.float().contiguous()
    residual = None if residual is None else residual.float()
    y = torch.empty((b, cout, ho, wo), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    err = library().conv_direct_launch(
        x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        b, h, w, cin, ho, wo, cout, k, stride, pad_t, pad_l, int(leaky),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, name)
    return y.to(dtype)


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
