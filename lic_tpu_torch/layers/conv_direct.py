"""Kernels B3 and B6 and the Up5 deconv (``csrc/conv_direct.cu``): wrappers
and plain versions.

* B3 ``conv5s2`` — ``ZeroPad2d(1, 2, 1, 2)`` + 5×5 stride-2 conv, replacing
  ``lic_tpu/layers/pallas_conv.py::conv5s2_pallas`` (and ``_v2``, the same
  function); plain version ``conv5s2_plain``.
* B6 ``convk_s1`` — stride-1 "same" k×k conv with the optional bias,
  LeakyReLU (slope 0.01) and residual epilogue, replacing
  ``lic_tpu/layers/pallas_conv_s1.py::convk_s1_pallas``; plain version
  ``convk_s1_plain``.
* ``up5`` — g_s's ``ZeroPad2d(1, 0, 1, 0)`` + ``ConvTranspose2d(5, stride 2,
  padding 3, output_padding 1)``, H → 2H, replacing no Pallas kernel (the
  JAX package leaves it to XLA, ``lic_tpu/layers/conv.py:545-570``):
  cuDNN's fp32 deconv held two thirds of ``source_net``'s decode on an
  H100.  The output's four phases (row and column mod 2) are stride-1
  correlations over the input with 3×3, 3×2, 2×3 and 2×2 taps
  (``deconv_phase_taps``): the kernel walks each phase's taps on B3/B6's
  mainloop, with no zero tap, and writes each phase's pixels into their
  interleaved places; plain version ``up5_plain`` (the same correlations,
  interleaved).  The tile's width follows C_out (``up5_tile_width``):
  96, or 16 / 8 for g_s's last deconv (C_out M = 16 into the generated
  conv, or 3 where g_s gives RGB).

Tensors are NCHW in ``channels_last`` memory (the kernels read NHWC), fp32
or bf16, weights OIHW.  The kernel computes in fp32: a bf16 call is widened
at the kernel boundary (exactly) and its output rounded back to bf16 — bf16
operands, an fp32 sum, a bf16 result, as the JAX package's bf16 convs.  CPU
tensors take the plain version; CUDA tensors launch the kernel, built at
first use; any other device, another memory format or dtype raises, and so
does a C_in that is no multiple of 4 (the kernel's TMA loads need 16-byte
rows; ``Conv2d`` and ``_Up5`` keep such convs out of the slots).  ``Conv2d``
sends its B3 and B6 slots here, under the JAX package's gates, and g_s's
``_Up5`` its deconv.

Under autograd each wrapper runs its ``torch.autograd.Function``: the
forward is the kernel (the plain version on the CPU), the backward is the
plain conv's own gradient (``conv5s2_backward``, ``convk_s1_backward``:
``aten.convolution_backward``, which autograd of ``F.conv2d`` calls), as
the JAX package's ``custom_vjp``s take ``jax.vjp`` of the XLA conv
(``lic_tpu/layers/conv.py:326-329,353-356,385-388``); ``up5``'s backward
is the transposed conv's (``up5_backward``).  Each backward counts one in
the wrapper's ``backwards``.  Under autograd B6 keeps its
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
tensor (``up5``: per phase, ``pack_up5_weight``) and rebuilds it when the
weight changes in place (its version counter) or moves (its
``data_ptr``).  Two updates leave the counter
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
    lib.conv_up5_launch.restype = ctypes.c_int
    lib.conv_up5_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv_direct_occupancy.restype = ctypes.c_int
    lib.conv_direct_occupancy.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2


library = CudaLibrary("conv_direct.cu", _bind)

# _Up5's deconv (kernel size, stride, padding) and pre-pad (left = top)
UP5 = (5, 2, 3)
UP5_PRE_PAD = 1
# its output phases (row, column mod 2) in the kernel's grid order, most
# taps first; ``pack_up5_weight`` stores their taps in this order
UP5_PHASES = ((1, 1), (1, 0), (0, 1), (0, 0))

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


def deconv_phase_taps(k: int, stride: int, padding: int) -> dict:
    """``ConvTranspose2d``'s output phases as stride-1 correlations over its
    input: phase r (output index mod ``stride``) → [(tap j of the flipped
    kernel, input offset d)], j ascending (so d too), with
    ``y[stride·m + r] = Σ W[k-1-j] · x[m + d]`` on each axis; every tap of
    the k lies in exactly one phase."""
    lead = k - 1 - padding
    taps = {}
    for r in range(stride):
        for j in range(k):
            if (r + j - lead) % stride == 0:
                taps.setdefault(r, []).append((j, (r + j - lead) // stride))
    return taps


def up5_phase_weights(weight: torch.Tensor):
    """``_Up5``'s deconv weight (C_in, C_out, 5, 5) → per phase of
    ``UP5_PHASES`` the OIHW correlation kernel (C_out, C_in, T_h, T_w) over
    the unpadded input, and its (top, left) input offset."""
    taps = deconv_phase_taps(*UP5)
    wf = weight.flip(2, 3).permute(1, 0, 2, 3)  # the correlation kernel
    out = []
    for ry, rx in UP5_PHASES:
        jh = [j for j, _ in taps[ry]]
        jw = [j for j, _ in taps[rx]]
        off = (taps[ry][0][1] - UP5_PRE_PAD, taps[rx][0][1] - UP5_PRE_PAD)
        out.append((wf[:, :, jh][:, :, :, jw], off))
    return out


def pack_up5_weight(weight: torch.Tensor):
    """``_Up5``'s deconv weight (C_in, C_out, 5, 5) → ``(w_hi, w_lo)``, each
    ``(C_out, 25, C_in)`` contiguous fp32: the phases of ``UP5_PHASES`` one
    after another, each's taps row-major, what the kernel's weight maps
    read."""
    with torch.no_grad():
        w = torch.cat([p.permute(0, 2, 3, 1).reshape(p.shape[0], -1, p.shape[1])
                       for p, _ in up5_phase_weights(weight.detach())], 1)
        return tf32_split(w.contiguous())


def prepacked(weight: torch.Tensor, pack=pack_weight):
    """``pack(weight)``, cached on the weight tensor; rebuilt when the
    weight changes in place or its storage, device or shape changes, and
    after any ``torch.optim`` step over it."""
    key = (pack, weight._version, weight.data_ptr(), weight.device, tuple(weight.shape))
    cached = getattr(weight, "_tf32_prepack", None)
    if cached is None or cached[0] != key:
        _drop_after_optimizer_steps()
        cached = (key, *pack(weight))
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


def occupancy(up5_width: int = 0) -> tuple:
    """(shared memory bytes per CTA, CTAs resident per SM) of B3/B6's
    kernel, or of Up5's with tile width ``up5_width`` (96, 16 or 8), from the
    card's occupancy calculator (builds the library; needs CUDA)."""
    smem, ctas = ctypes.c_int(0), ctypes.c_int(0)
    check_launch(library().conv_direct_occupancy(up5_width, ctypes.byref(smem),
                                                 ctypes.byref(ctas)), "conv_direct_occupancy")
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


def up5_plain(x, weight, bias=None):
    """``F.pad`` (1, 0, 1, 0) + ``F.conv_transpose2d`` (stride 2, padding
    3, output_padding 1), H → 2H, as the kernel computes it: each phase of
    ``UP5_PHASES`` a stride-1 ``F.conv2d`` over x, written into its
    interleaved places of a ``channels_last`` output."""
    b, _, h, w = x.shape
    y = torch.empty((b, weight.shape[1], 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    for (ry, rx), (wp, (dy, dx)) in zip(UP5_PHASES, up5_phase_weights(weight)):
        th, tw = wp.shape[-2:]
        xp = F.pad(x, (-dx, dx + tw - 1, -dy, dy + th - 1))
        y[:, :, ry::2, rx::2] = F.conv2d(xp, wp, bias)
    return y


def _conv_grads(g, x, weight, has_bias, stride, pad, needs, transposed=False,
                output_padding=0):
    """``aten.convolution_backward`` of ``F.conv2d(x, weight, bias, stride,
    pad)`` (``transposed``: of ``F.conv_transpose2d`` with
    ``output_padding``) for the cotangent ``g`` → (dx, dw, db), None where
    ``needs`` (x, weight, bias) says no gradient is wanted."""
    mask = [bool(needs[0]), bool(needs[1]), bool(has_bias and needs[2])]
    cout = weight.shape[1] if transposed else weight.shape[0]
    dx, dw, db = torch.ops.aten.convolution_backward(
        g.to(x.dtype), x, weight, [cout] if has_bias else None, [stride, stride], [pad, pad],
        [1, 1], transposed, [output_padding] * 2, 1, mask)
    return (dx if mask[0] else None, dw if mask[1] else None, db if mask[2] else None)


def conv5s2_backward(g, x, weight, bias, needs=(True, True, True)):
    """The gradient of ``conv5s2_plain`` → (dx, dW, db)."""
    xp = F.pad(x, (1, 2, 1, 2))
    dxp, dw, db = _conv_grads(g, xp, weight, bias is not None, 2, 0, needs)
    h, w = x.shape[-2:]
    return (None if dxp is None else dxp[:, :, 1 : 1 + h, 1 : 1 + w], dw, db)


def up5_backward(g, x, weight, bias, needs=(True, True, True)):
    """The gradient of ``up5_plain`` (of the padded transposed conv) →
    (dx, dW, db)."""
    _, stride, pad = UP5
    p = UP5_PRE_PAD
    xp = F.pad(x, (p, 0, p, 0))
    dxp, dw, db = _conv_grads(g, xp, weight, bias is not None, stride, pad, needs,
                              transposed=True, output_padding=1)
    return (None if dxp is None else dxp[:, :, p:, p:], dw, db)


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


def _check(name, x, weight, bias, residual, wcin, cout, k, k2):
    check_cuda_inputs(name, x, weight, bias, residual)
    _channels_last(name, x)
    cin = x.shape[1]
    if wcin != cin or k != k2:
        raise ValueError(f"{name}: weight {tuple(weight.shape)} vs input channels {cin}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} vs {cout} channels")
    if cin % 4:
        raise ValueError(f"{name}: C_in {cin} is no multiple of 4 (the kernel's TMA "
                         "loads need rows of whole 16 bytes)")


def _launch(name, x, weight, bias, residual, stride, pad_t, pad_l, ho, wo, leaky):
    b, cin, h, w = x.shape
    cout, wcin, k, k2 = weight.shape
    _check(name, x, weight, bias, residual, wcin, cout, k, k2)
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


def up5_tile_width(cout: int) -> int:
    """The Up5 kernel's tile width for ``cout`` output channels: 8 or 16
    for g_s's narrow last deconv (C_out 3, or M = 16), else 96."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 96


def _up5_forward(x, weight, bias):
    if x.device.type == "cpu":
        return up5_plain(x, weight, bias)
    b, cin, h, w = x.shape
    wcin, cout, k, k2 = weight.shape
    if k != UP5[0]:
        raise ValueError(f"up5: 5x5 weight needed, got {tuple(weight.shape)}")
    _check("up5", x, weight, bias, None, wcin, cout, k, k2)
    w_hi, w_lo = prepacked(weight, pack_up5_weight)
    dtype = x.dtype
    x = x.float()
    bias = None if bias is None else bias.float().contiguous()
    y = torch.empty((b, cout, 2 * h, 2 * w), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    err = library().conv_up5_launch(
        x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        b, h, w, cin, cout, up5_tile_width(cout),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "up5")
    up5.launches += 1
    return y.to(dtype)


class _Conv5s2Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _conv5s2_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        conv5s2.backwards += 1
        return conv5s2_backward(g, *ctx.saved_tensors, ctx.needs_input_grad)


class _Up5Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _up5_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        up5.backwards += 1
        return up5_backward(g, *ctx.saved_tensors, ctx.needs_input_grad)


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


def up5(x: torch.Tensor, weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ZeroPad2d(1, 0, 1, 0)`` + ``ConvTranspose2d(5, 2, 3,
    output_padding=1)`` (+ bias): H × W → 2H × 2W; ``weight`` is the
    deconv's (C_in, C_out, 5, 5)."""
    if needs_grad(x, weight, bias):
        return _Up5Fn.apply(x, weight, bias)
    return _up5_forward(x, weight, bias)


up5.launches = 0
up5.backwards = 0
