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
rows; ``Conv2d`` keeps such convs out of the slots).  ``Conv2d`` sends its
B3 and B6 slots here, under the JAX package's gates.

Under autograd each wrapper runs its ``torch.autograd.Function``: the
forward is the kernel (the plain version on the CPU), the backward is the
plain conv's own gradient (``conv5s2_backward``, ``convk_s1_backward``:
``aten.convolution_backward``, which autograd of ``F.conv2d`` calls), as
the JAX package's ``custom_vjp``s take ``jax.vjp`` of the XLA conv
(``lic_tpu/layers/conv.py:326-329,353-356,385-388``).  Each backward
counts one in the wrapper's ``backwards``.  Under autograd B6 keeps its
LeakyReLU and the forward keeps the sign of the kernel's output for the
backward (``LEAKY_SLOPE > 0``: the same as the pre-activation's); the
residual, where there is one, is then added in torch.  A recompute of the
pre-activation by cuDNN's fp32 conv, as JAX's VJP recomputes its XLA conv,
costs about 126 ms a call at B = 1 on 128×192 maps of 192 channels on an
H100 (cuDNN's heuristics pick an FFT path there; ``profile_path --tune``).

The kernel runs 3xTF32 on the tensor cores: each fp32 operand is split into
``hi = tf32(a)`` and ``lo = tf32(a - hi)`` (``tf32_split``), and a·b is
summed as hi·lo + lo·hi + hi·hi.  The weight's split is made here, once per
weight: ``prepacked`` keeps an OHWI ``(w_hi, w_lo)`` pair on the weight
tensor and rebuilds it when the weight changes in place (its version
counter) or moves (its ``data_ptr``).  Two updates leave the counter
where it was: a write through ``weight.data``, and a fused optimizer
(``torch.optim.Adam(fused=True)`` writes the parameters in its own kernel).
So the first split also registers a ``torch.optim`` step post-hook that
drops the cache of every parameter an optimizer steps (``drop_prepacked``),
whatever the optimizer; after a write through ``.data``, call
``drop_prepacked`` yourself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.optim.optimizer import register_optimizer_step_post_hook

from ..utils.build import CudaLibrary, check_cuda_inputs, check_launch, needs_grad

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


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope·x)``, whose gradient
    at 0 is 1 (torch's ``F.leaky_relu`` takes ``slope`` there; a zero-init
    conv feeds it exact zeros).  Without autograd, ``F.leaky_relu`` (the
    same values)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, x * slope)
    return F.leaky_relu(x, slope)


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
    the weight changes in place or its storage, device or shape changes,
    and after any ``torch.optim`` step over it."""
    key = (weight._version, weight.data_ptr(), weight.device, tuple(weight.shape))
    cached = getattr(weight, "_tf32_prepack", None)
    if cached is None or cached[0] != key:
        _drop_after_optimizer_steps()
        cached = (key, *pack_weight(weight))
        weight._tf32_prepack = cached
    return cached[1], cached[2]


def drop_prepacked(tensors) -> None:
    """Forget the cached split of each tensor given, so that the next
    kernel call packs the weight as it is then."""
    for t in tensors:
        t.__dict__.pop("_tf32_prepack", None)


@functools.lru_cache(maxsize=None)
def _drop_after_optimizer_steps() -> None:
    """Register, once per process, a post-hook on every ``torch.optim``
    optimizer's step that drops the split of the parameters it stepped."""

    def hook(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            drop_prepacked(group["params"])

    register_optimizer_step_post_hook(hook)


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
        y = leaky_relu(y)
    elif act is not None:
        raise ValueError(f"unknown act {act!r}")
    return y if residual is None else y + residual


def _conv_grads(g, x, weight, has_bias, stride, pad, needs):
    """``aten.convolution_backward`` of ``F.conv2d(x, weight, bias, stride,
    pad)`` for the cotangent ``g`` → (dx, dw, db), None where ``needs``
    (x, weight, bias) says no gradient is wanted."""
    mask = [bool(needs[0]), bool(needs[1]), bool(has_bias and needs[2])]
    dx, dw, db = torch.ops.aten.convolution_backward(
        g.to(x.dtype), x, weight, [weight.shape[0]] if has_bias else None,
        [stride, stride], [pad, pad], [1, 1], False, [0, 0], 1, mask)
    return (dx if mask[0] else None, dw if mask[1] else None, db if mask[2] else None)


def conv5s2_backward(g, x, weight, bias, needs=(True, True, True)):
    """The gradient of ``conv5s2_plain`` → (dx, dW, db)."""
    xp = F.pad(x, (1, 2, 1, 2))
    dxp, dw, db = _conv_grads(g, xp, weight, bias is not None, 2, 0, needs)
    h, w = x.shape[-2:]
    return (None if dxp is None else dxp[:, :, 1 : 1 + h, 1 : 1 + w], dw, db)


def convk_s1_backward(g, x, weight, bias, positive, has_residual, needs=(True,) * 4):
    """The gradient of ``convk_s1_plain`` → (dx, dW, db, d residual), the
    last None without a residual.  ``positive`` is the LeakyReLU's
    ``pre-activation >= 0`` as the forward computed it (None without the
    LeakyReLU): the gradient is 1 there, 1 at 0 too as
    ``jax.nn.leaky_relu``'s, and the slope elsewhere."""
    gz = g if positive is None else torch.where(positive, g, g * LEAKY_SLOPE)
    dx, dw, db = _conv_grads(gz, x, weight, bias is not None, 1, weight.shape[-1] // 2,
                             needs[:3])
    return dx, dw, db, (g if has_residual and needs[3] else None)


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


def _conv5s2_forward(x, weight, bias):
    if x.device.type == "cpu":
        return conv5s2_plain(x, weight, bias)
    h, w = x.shape[-2:]
    if weight.shape[-1] != 5 or h % 2 or w % 2:
        raise ValueError(f"conv5s2: 5x5 weight and even H, W needed, got "
                         f"{tuple(weight.shape)} on {h}x{w}")
    y = _launch("conv5s2", x, weight, bias, None, 2, 1, 1, h // 2, w // 2, False)
    conv5s2.launches += 1
    return y


def _convk_s1_forward(x, weight, bias, act, residual):
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


class _Conv5s2Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _conv5s2_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        conv5s2.backwards += 1
        return conv5s2_backward(g, *ctx.saved_tensors, ctx.needs_input_grad)


class _ConvkS1Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, act, residual):
        ctx.has_residual = residual is not None
        if act != "leaky_relu":
            ctx.save_for_backward(x, weight, bias, None)
            return _convk_s1_forward(x, weight, bias, act, residual)
        # the kernel with its LeakyReLU, the residual (convk_s1_plain's last
        # step) added after, so that the output's sign is the
        # pre-activation's (but where a negative one's product with the
        # slope underflows to -0)
        y = _convk_s1_forward(x, weight, bias, act, None)
        ctx.save_for_backward(x, weight, bias, y >= 0)
        return y if residual is None else y + residual

    @staticmethod
    def backward(ctx, g):
        convk_s1.backwards += 1
        n = ctx.needs_input_grad
        dx, dw, db, dres = convk_s1_backward(
            g, *ctx.saved_tensors, ctx.has_residual, (n[0], n[1], n[2], n[4]))
        return dx, dw, db, None, dres


def conv5s2(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3: ``ZeroPad2d(1, 2, 1, 2)`` + 5×5 stride-2 conv (+ bias), even H, W."""
    if needs_grad(x, weight, bias):
        return _Conv5s2Fn.apply(x, weight, bias)
    return _conv5s2_forward(x, weight, bias)


conv5s2.launches = 0
conv5s2.backwards = 0


def convk_s1(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6: stride-1 "same" k×k conv (k odd), then + bias, LeakyReLU if
    ``act == 'leaky_relu'``, then + ``residual``."""
    if needs_grad(x, weight, bias, residual):
        return _ConvkS1Fn.apply(x, weight, bias, act, residual)
    return _convk_s1_forward(x, weight, bias, act, residual)


convk_s1.launches = 0
convk_s1.backwards = 0
