"""Kernels B4 and B5 (``csrc/window_attn.cu``): window helpers, wrappers and
plain versions.

* B4 ``window_attention`` — qkv (B, Hp, Wp, 3C) → (B, Hp, Wp, C): per ws×ws
  window and head, softmax(q·kᵀ·hd^-½ + rel-pos bias + mask)·v; replaces
  ``lic_tpu/layers/pallas_attn.py::window_attention_fused``.  Plain version
  ``wba_plain`` (the counterpart of ``_wba_reference``).
* B5 ``window_attention_proj`` — x (B, Hp, Wp, C) → (B, Hp, Wp, C), B4 with
  the qkv and output projections inside; replaces
  ``window_attention_fused_proj``.  Plain version ``wba_proj_plain``
  (``_wba_proj_reference``).

Maps are NHWC (contiguous), padded to the window grid and rolled: the pad
and the roll stay outside the kernels, the windowing happens inside.
``rel`` is the gathered bias (nh, n, n), ``mask`` the additive (nW, n, n)
mask of one image's nW windows, or None.  Projection weights are in
torch's ``Linear`` layout (out, in), which B5 reads as it is.  CPU tensors
take the plain versions; CUDA tensors launch the kernels (ws ∈ {4, 8},
head width hd ∈ {8, 24, 48}, B5 at (C, hd) ∈ {(192, 24), (16, 8), (384,
48)}: ``b4_takes`` and ``b5_takes``), built at first use; anything else
raises.  The kernels
compute in fp32: bf16 tensors are widened at the kernel boundary and the
output is rounded back to bf16 (bf16 operands, an fp32 sum, a bf16 result).

Under autograd each wrapper runs its ``torch.autograd.Function``: the
forward is the kernel (the plain version on the CPU), the backward is
autograd of ``wba_plain`` / ``wba_proj_plain`` recomputed from the saved
inputs, as the JAX package's VJPs take ``jax.vjp`` of ``_wba_reference``
and ``_wba_proj_reference`` (``lic_tpu/layers/pallas_attn.py:471-476,
502-510``).  The mask gets no gradient.  Each backward counts one in the
wrapper's ``backwards``.

Also here, as in ``lic_tpu/layers/win_attention.py:55-119``:
``window_partition``, ``window_reverse``, ``relative_position_index`` and
``swin_shift_mask``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.build import CudaLibrary, check_cuda_inputs, check_launch, needs_grad


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """Pairwise relative-position index into a (2ws-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws², ws²)


def swin_shift_mask(
    h: int, w: int, ws: int, shift: int, pad_b: int = 0, pad_r: int = 0
) -> np.ndarray:
    """SW-MSA additive mask (nW, ws², ws²), 0 / -100.  The pad tokens of a
    canvas extended to (h + pad_b, w + pad_r) get a region of their own, so
    real tokens never attend to padding."""
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
        # the pad flag lives on the unrolled canvas; the region ids above
        # are in rolled coordinates, so roll the flag to match
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
def shift_mask(h, w, ws, shift, pad_b, pad_r, device) -> Optional[torch.Tensor]:
    """``swin_shift_mask`` as a tensor on ``device``, built once per shape;
    None where no window needs a mask."""
    if not (shift > 0 or pad_b or pad_r):
        return None
    return torch.from_numpy(swin_shift_mask(h, w, ws, shift, pad_b, pad_r)).to(device)


@functools.lru_cache(maxsize=8)
def rel_index(ws: int, device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(ws).reshape(-1)).to(device)


def wba_plain(qkv, rel, mask, ws: int, nh: int) -> torch.Tensor:
    """Plain W-MSA core: qkv (B, Hp, Wp, 3C) → (B, Hp, Wp, C); the mask is
    added in the logits' dtype."""
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    hd = c // nh
    win = window_partition(qkv, ws)
    heads = lambda t: t.reshape(-1, n, nh, hd).transpose(1, 2)  # (bw, nh, n, hd)
    q = heads(win[..., :c] * hd ** -0.5)
    k, v = heads(win[..., c : 2 * c]), heads(win[..., 2 * c :])
    logits = q @ k.transpose(-1, -2) + rel[None]
    if mask is not None:
        nw = mask.shape[0]
        mask = mask.to(logits.dtype)
        logits = (logits.reshape(b, nw, nh, n, n) + mask[None, :, None]).reshape(-1, nh, n, n)
    o = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
    return window_reverse(o, ws, hp, wp)


def wba_proj_plain(x, rel, wqkv, bqkv, wproj, bproj, mask, ws: int, nh: int):
    """Plain fully-fused W-MSA: x (B, Hp, Wp, C) → (B, Hp, Wp, C)."""
    return F.linear(wba_plain(F.linear(x, wqkv, bqkv), rel, mask, ws, nh), wproj, bproj)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wba_launch.restype = i
    lib.wba_launch.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
    lib.wba_proj_launch.restype = i
    lib.wba_proj_launch.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
    lib.wba_occupancy.restype = i
    lib.wba_occupancy.argtypes = [i] * 4 + [ctypes.POINTER(i)] * 2


library = CudaLibrary("window_attn.cu", _bind)


# head widths the kernels are built for (template constants), and B5's
# (C, head width) pairs: its output accumulator is sized by C
B4_HEAD_DIMS = (8, 24, 48)
B5_WIDTHS = ((192, 24), (16, 8), (384, 48))


def b4_takes(ws: int, hd: int) -> bool:
    """Whether B4 is built for window ``ws`` and head width ``hd``."""
    return ws in (4, 8) and hd in B4_HEAD_DIMS


def b5_takes(ws: int, c: int, hd: int) -> bool:
    """Whether B5 is built for window ``ws``, width ``c``, head width ``hd``."""
    return ws in (4, 8) and (c, hd) in B5_WIDTHS


def _fp32(*ts):
    """Each tensor (None kept) widened to fp32 and contiguous: the kernels'
    operands.  A bf16 value widens exactly."""
    return [None if t is None else t.float().contiguous() for t in ts]


def _check(name, x, c, rel, mask, ws, nh, *params):
    check_cuda_inputs(name, x, rel, mask, *params)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous NHWC map, got strides {x.stride()}")
    b, hp, wp, _ = x.shape
    n = ws * ws
    if ws not in (4, 8) or hp % ws or wp % ws or c % nh or b * hp * wp >= 2**31:
        raise ValueError(f"{name}: ws={ws}, nh={nh} on {hp}x{wp}x{c} not supported")
    if tuple(rel.shape) != (nh, n, n):
        raise ValueError(f"{name}: rel {tuple(rel.shape)} != {(nh, n, n)}")
    if mask is not None and tuple(mask.shape) != ((hp // ws) * (wp // ws), n, n):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} vs the window grid")


def _aligned(name, *ts):
    """The kernels read 16-byte vectors of every tensor (None skipped)."""
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: a tensor is not 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _plain_vjp(plain, g, tensors, needs, *rest):
    """Gradients of ``plain(*tensors, *rest)`` for the cotangent ``g``,
    recomputed with autograd: one per tensor, None where ``needs`` is
    false."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(tensors, needs)]
        y = plain(*ins, *rest)
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
    return [next(got) if t.requires_grad else None for t in ins]


def wba_backward(g, qkv, rel, mask, ws: int, nh: int, needs=(True, True)):
    """The gradient of ``wba_plain`` → (d qkv, d rel)."""
    return tuple(_plain_vjp(lambda q, r: wba_plain(q, r, mask, ws, nh), g, (qkv, rel), needs))


def wba_proj_backward(g, x, rel, wqkv, bqkv, wproj, bproj, mask, ws: int, nh: int,
                      needs=(True,) * 6):
    """The gradient of ``wba_proj_plain`` → (dx, d rel, dW_qkv, db_qkv,
    dW_proj, db_proj)."""
    fn = lambda *t: wba_proj_plain(*t, mask, ws, nh)
    return tuple(_plain_vjp(fn, g, (x, rel, wqkv, bqkv, wproj, bproj), needs))


def _wba_forward(qkv, rel, mask, ws, nh):
    if qkv.device.type == "cpu":
        return wba_plain(qkv, rel, mask, ws, nh)
    b, hp, wp, c3 = qkv.shape
    _check("window_attention", qkv, c3 // 3, rel, mask, ws, nh)
    if c3 // 3 // nh not in B4_HEAD_DIMS:
        raise ValueError(f"window_attention: head width {c3 // 3 // nh} not supported "
                         f"(kernel built for {B4_HEAD_DIMS})")
    dtype = qkv.dtype
    qkv, rel, mask = _fp32(qkv, rel, mask)
    _aligned("window_attention", qkv, rel, mask)
    out = qkv.new_empty((b, hp, wp, c3 // 3))
    err = library().wba_launch(
        qkv.data_ptr(), rel.data_ptr(), _ptr(mask), out.data_ptr(),
        b, hp, wp, c3 // 3, nh, ws, (c3 // 3 // nh) ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    check_launch(err, "window_attention")
    window_attention.launches += 1
    key = ((b, hp, wp, c3), ws, nh, mask is not None)
    window_attention.calls[key] = window_attention.calls.get(key, 0) + 1
    return out.to(dtype)


def _wba_proj_forward(x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh):
    if x.device.type == "cpu":
        return wba_proj_plain(x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh)
    b, hp, wp, c = x.shape
    _check("window_attention_proj", x, c, rel, mask, ws, nh, wqkv, bqkv, wproj, bproj)
    if (c, c // nh) not in B5_WIDTHS:
        raise ValueError(f"window_attention_proj: C={c} with head width {c // nh} not "
                         f"supported (kernel built for (C, hd) in {B5_WIDTHS})")
    if tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c):
        raise ValueError(f"window_attention_proj: weights {tuple(wqkv.shape)}, "
                         f"{tuple(wproj.shape)} vs C={c}")
    if not all(t.is_contiguous() for t in (wqkv, bqkv, wproj, bproj)):
        raise ValueError("window_attention_proj: weights and biases must be contiguous")
    dtype = x.dtype
    x, rel, mask, wqkv, bqkv, wproj, bproj = _fp32(x, rel, mask, wqkv, bqkv, wproj, bproj)
    _aligned("window_attention_proj", x, rel, mask, wqkv, wproj)
    out = x.new_empty((b, hp, wp, c))
    err = library().wba_proj_launch(
        x.data_ptr(), rel.data_ptr(), _ptr(mask), wqkv.data_ptr(), bqkv.data_ptr(),
        wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
        b, hp, wp, c, nh, ws, (c // nh) ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "window_attention_proj")
    window_attention_proj.launches += 1
    return out.to(dtype)


class _WbaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rel, mask, ws, nh):
        ctx.save_for_backward(qkv, rel, mask)
        ctx.ws, ctx.nh = ws, nh
        return _wba_forward(qkv, rel, mask, ws, nh)

    @staticmethod
    def backward(ctx, g):
        window_attention.backwards += 1
        qkv, rel, mask = ctx.saved_tensors
        dq, dr = wba_backward(g, qkv, rel, mask, ctx.ws, ctx.nh, ctx.needs_input_grad[:2])
        return dq, dr, None, None, None


class _WbaProjFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh):
        ctx.save_for_backward(x, rel, wqkv, bqkv, wproj, bproj, mask)
        ctx.ws, ctx.nh = ws, nh
        return _wba_proj_forward(x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh)

    @staticmethod
    def backward(ctx, g):
        window_attention_proj.backwards += 1
        *ts, mask = ctx.saved_tensors
        grads = wba_proj_backward(g, *ts, mask, ctx.ws, ctx.nh, ctx.needs_input_grad[:6])
        return (*grads, None, None, None)


def window_attention(qkv, rel, mask, ws: int, nh: int) -> torch.Tensor:
    """B4: qkv (B, Hp, Wp, 3C) NHWC → (B, Hp, Wp, C).  Each launch counts
    one in ``launches`` and in ``calls[(qkv shape, ws, nh, masked)]``."""
    if needs_grad(qkv, rel):
        return _WbaFn.apply(qkv, rel, mask, ws, nh)
    return _wba_forward(qkv, rel, mask, ws, nh)


window_attention.launches = 0
window_attention.backwards = 0
window_attention.calls = {}


def window_attention_proj(x, rel, wqkv, bqkv, wproj, bproj, mask, ws: int, nh: int):
    """B5: x (B, Hp, Wp, C) NHWC → (B, Hp, Wp, C), both projections inside."""
    if needs_grad(x, rel, wqkv, bqkv, wproj, bproj):
        return _WbaProjFn.apply(x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh)
    return _wba_proj_forward(x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh)


window_attention_proj.launches = 0
window_attention_proj.backwards = 0


def occupancy(proj: bool, ws: int, hd: int, c: int) -> tuple:
    """(shared memory bytes per CTA, CTAs resident per SM) of B5 (``proj``)
    or B4 at window size ``ws``, head width ``hd`` and width ``c``, from the
    card's occupancy calculator (builds the library; needs CUDA)."""
    smem, ctas = ctypes.c_int(0), ctypes.c_int(0)
    check_launch(library().wba_occupancy(int(proj), ws, hd, c, ctypes.byref(smem),
                                         ctypes.byref(ctas)), "wba_occupancy")
    return smem.value, ctas.value
