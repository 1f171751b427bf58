"""GDN / IGDN, and kernel B2: the fused GDN forward in CUDA C++.

``y = x · (x²Γᵀ + β)^∓½`` over (rows, C), Γ indexed ``[out, in]``
(``lic_tpu/layers/gdn.py:65-102``).  The module stores β/Γ in
``NonNegativeParametrizer`` space with the JAX package's inits
(β = sqrt(1 + ped), Γ = sqrt(0.1·I + ped), ``gdn.py:46-62``).

Kernel B2 (``csrc/gdn.cu``) replaces ``lic_tpu/layers/pallas_gdn.py::gdn_fused``
(``_gdn_fwd_pallas`` → ``_gdn_kernel``): it reads x once and writes y once.
For 16 < C ≤ 192 (C % 4 == 0) the product x²Γᵀ runs 3xTF32 on the tensor
cores (``wgmma``, x fed by TMA, Γ split hi/lo by each CTA into shared memory
on every call, so no cache can key on a reused address); for C ≤ 16 a
CUDA-core kernel.  The source's head note says what bounds it and why.
bf16 inputs are widened to fp32 (exact), squared and rounded to bf16 in the
kernel as the TPU kernel squares, and y is rounded back to bf16.

``gdn_fused`` is the wrapper: CPU tensors take ``gdn_plain``, CUDA tensors
launch the kernel, anything else raises.  The ``GDN`` module sends a
tensor whose width B2 does not take (``b2_takes``: C > 192, or 16 < C with
C % 4 ≠ 0) to ``gdn_plain_route``, the plain version, counted like a
kernel: the JAX package's default GDN is its XLA path at every
width (``lic_tpu/layers/gdn.py:34,85``).  ``GDN1`` (``gdn.py:110-131``),
y = x / (β + Γ|x|), is plain torch: no TPU kernel computes it.

The gradient of ``gdn_fused`` is ``_GdnFn``, a ``torch.autograd.Function``
whose forward is the kernel (the plain version on the CPU) and whose
backward is ``gdn_plain_backward``: the closed-form VJP of the JAX
package's ``_gdn_fused_bwd`` (``lic_tpu/layers/pallas_gdn.py:80-108``) in
plain torch, fp32.  Each backward counts one in ``gdn_fused.backwards``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from ..ops.bounds import NonNegativeParametrizer
from ..utils.build import CudaLibrary, check_launch, needs_grad

_BETA_MIN = 1e-6
_GAMMA_INIT = 0.1
_MAX_C = 192  # the tensor-core kernel keeps 6 chunks of Γ's split resident


def _bind(lib: ctypes.CDLL) -> None:
    lib.gdn_launch.restype = ctypes.c_int
    lib.gdn_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gdn_occupancy.restype = ctypes.c_int
    lib.gdn_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2


library = CudaLibrary("gdn.cu", _bind)


def gdn_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """Plain PyTorch GDN on (rows, C); the norm in fp32 (in float64 for a
    float64 x), y in x's dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    norm = (xf * xf) @ gamma.to(ct).t() + beta.to(ct)
    y = xf * torch.sqrt(norm) if inverse else xf / torch.sqrt(norm)
    return y.to(x.dtype)


def b2_takes(c: int) -> bool:
    """Whether kernel B2 is built for width ``c``."""
    return c <= 16 or (c <= _MAX_C and c % 4 == 0)


def gdn_plain_route(x, gamma, beta, inverse):
    """``gdn_plain`` for a width B2 does not take; counted in
    ``gdn_plain_route.launches``."""
    gdn_plain_route.launches += 1
    return gdn_plain(x, gamma, beta, inverse)


gdn_plain_route.launches = 0


def occupancy():
    """(shared memory bytes per CTA, CTAs per SM) of the tensor-core kernel
    at C = 192, from the card's occupancy calculator."""
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    check_launch(library().gdn_occupancy(ctypes.byref(smem), ctypes.byref(ctas)), "gdn")
    return smem.value, ctas.value


def _launch(x, gamma, beta, inverse):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gdn kernel takes fp32 or bf16, got {x.dtype}")
    rows, c = x.shape
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} do not "
            f"match C={c}"
        )
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("gdn: x, gamma and beta must share a device")
    if not b2_takes(c):
        raise ValueError(f"gdn kernel takes C <= 16, or C <= {_MAX_C} with C % 4 == 0; got {c}")
    xk = x.float().contiguous()
    if xk.data_ptr() % 16:  # TMA reads from a 16-byte-aligned base
        xk = xk.clone()
    y = torch.empty_like(xk)
    if rows:
        g = gamma.float().contiguous()
        b = beta.float().contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library().gdn_launch(
            xk.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, c,
            int(bool(inverse)), int(x.dtype == torch.bfloat16), stream,
        )
        check_launch(err, "gdn")
        gdn_fused.launches += 1
    return y.to(x.dtype)


def gdn_plain_backward(g, x, gamma, beta, inverse):
    """The closed-form VJP of GDN/IGDN on (rows, C), in fp32:
    n = x²Γᵀ + β; t = −½·g·x·n^{−3/2} (GDN) or ½·g·x·n^{−½} (IGDN);
    dx = g·n^{∓½} + 2x·(tΓ), dΓ = tᵀx², dβ = Σ_rows t.  → (dx, dΓ, dβ) in
    the dtypes of x, Γ and β (float64 inputs: all in float64)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, gf, gam = x.to(ct), g.to(ct), gamma.to(ct)
    xsq = xf * xf
    n = xsq @ gam.t() + beta.to(ct)
    if inverse:
        sq = torch.sqrt(n)
        t = 0.5 * gf * xf / sq
        dx = gf * sq + 2.0 * xf * (t @ gam)
    else:
        rsq = torch.rsqrt(n)
        t = -0.5 * gf * xf * rsq / n
        dx = gf * rsq + 2.0 * xf * (t @ gam)
    return dx.to(x.dtype), (t.t() @ xsq).to(gamma.dtype), t.sum(0).to(beta.dtype)


def _forward(x, gamma, beta, inverse):
    if x.device.type == "cpu":
        return gdn_plain(x, gamma, beta, inverse)
    if x.device.type != "cuda":
        raise RuntimeError(f"gdn_fused: no kernel for device {x.device}")
    return _launch(x, gamma, beta, inverse)


class _GdnFn(torch.autograd.Function):
    """Forward: kernel B2 (the plain version on the CPU); backward:
    ``gdn_plain_backward`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        return _forward(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        gdn_fused.backwards += 1
        return (*gdn_plain_backward(g, *ctx.saved_tensors, ctx.inverse), None)


def gdn_fused(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """GDN/IGDN on (rows, C) — the counterpart of ``pallas_gdn.gdn_fused``.

    gamma: (C_out, C_in); beta: (C,).  CPU tensors take ``gdn_plain``;
    CUDA tensors launch kernel B2; any other device raises.  Under
    autograd the call goes through ``_GdnFn``."""
    if needs_grad(x, gamma, beta):
        return _GdnFn.apply(x, gamma, beta, inverse)
    return _forward(x, gamma, beta, inverse)


gdn_fused.launches = 0
gdn_fused.backwards = 0


class GDN(nn.Module):
    """``y = x / sqrt(β + Γx²)``, or ``x · sqrt(β + Γx²)`` when ``inverse``.
    NCHW in, NCHW out; the channel pass runs on the NHWC view."""

    def __init__(self, num_features: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self._beta_rp = NonNegativeParametrizer(minimum=_BETA_MIN)
        self._gamma_rp = NonNegativeParametrizer()
        c = num_features
        self.beta = nn.Parameter(self._beta_rp.init(torch.ones(c)))
        self.gamma = nn.Parameter(
            self._gamma_rp.init(_GAMMA_INIT * torch.eye(c))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        # channels_last NCHW ⇔ contiguous NHWC: the reshape is a view
        x2d = x.permute(0, 2, 3, 1).reshape(-1, c)
        fn = gdn_fused if b2_takes(c) else gdn_plain_route
        y = fn(x2d, self._gamma_rp(self.gamma), self._beta_rp(self.beta), self.inverse)
        return y.view(b, h, w, c).permute(0, 3, 1, 2)


def IGDN(num_features: int) -> GDN:
    """Reference IGDN: multiply by ``sqrt(norm)``."""
    return GDN(num_features, inverse=True)


class GDN1(nn.Module):
    """The simplified GDN of ``lic_tpu/layers/gdn.py:110-131``: ``y = x /
    (β + Γ|x|)``, or ``x · (β + Γ|x|)`` when ``inverse``; β/Γ stored and
    initialised as ``GDN``'s.  Plain torch: kernel B2 computes
    x·(x²Γᵀ + β)^∓½, and no TPU kernel computes this one.  NCHW."""

    def __init__(self, num_features: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self._beta_rp = NonNegativeParametrizer(minimum=_BETA_MIN)
        self._gamma_rp = NonNegativeParametrizer()
        c = num_features
        self.beta = nn.Parameter(self._beta_rp.init(torch.ones(c)))
        self.gamma = nn.Parameter(self._gamma_rp.init(_GAMMA_INIT * torch.eye(c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self._gamma_rp(self.gamma), self._beta_rp(self.beta)
        norm = torch.einsum("bihw,oi->bohw", x.abs(), gamma) + beta[:, None, None]
        return x * norm if self.inverse else x / norm


__all__ = ["GDN", "GDN1", "IGDN", "b2_takes", "gdn_fused", "gdn_plain", "gdn_plain_backward",
           "gdn_plain_route"]
