"""GDN / IGDN, and kernel B2: the fused GDN forward in Triton.

``y = x · (x²Γᵀ + β)^∓½`` over (rows, C), Γ indexed ``[out, in]``
(``lic_tpu/layers/gdn.py:65-102``).  The module stores β/Γ in
``NonNegativeParametrizer`` space with the JAX package's inits
(β = sqrt(1 + ped), Γ = sqrt(0.1·I + ped), ``gdn.py:46-62``).

Kernel B2 — replaces ``lic_tpu/layers/pallas_gdn.py::gdn_fused``
(``_gdn_fwd_pallas`` → ``_gdn_kernel``).

* What bounds it on this card: the pass reads x once and writes y once;
  its one product is a row tile times the C×C Γ (C ≤ 192).  In bf16 that
  is far below the ~295 FLOP/byte ridge of an H100, so bytes bound it.
  In fp32 the product runs in IEEE fp32 on the CUDA cores (TF32 would
  break the 1e-5 parity), at 2·C FLOP per element read: near the ridge of
  the fp32 FMA rate at C = 192.
* What the design does: one program per 64-row tile loads the x tile once
  (masked to the next power of two of C, 256 for C = 192), squares it in
  registers and runs ``tl.dot`` against Γᵀ in 64-wide output-channel
  blocks, each followed by the sqrt/rsqrt epilogue and the store.  The
  per-block re-read of x's output columns hits L1/L2, so device memory
  sees x once and y once — the property the TPU kernel was written for
  (``pallas_gdn.py:3-8``).  The norm accumulates in fp32 for bf16 inputs,
  as ``pallas_gdn.py:35`` does; fp32 inputs pass
  ``input_precision="ieee"`` so ``tl.dot`` does not drop to TF32.

``gdn_fused`` is the wrapper: CPU tensors take ``gdn_plain``, CUDA tensors
launch the kernel, anything else raises.  The backward comes with training;
a backward through the CUDA path raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bounds import NonNegativeParametrizer

_BLOCK_R = 64
_BLOCK_N = 64
_KERNEL = None
_BETA_MIN = 1e-6
_GAMMA_INIT = 0.1


def gdn_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """Plain PyTorch GDN on (rows, C); the norm in fp32, y in x's dtype."""
    xf = x.float()
    norm = (xf * xf) @ gamma.float().t() + beta.float()
    y = xf * torch.sqrt(norm) if inverse else xf / torch.sqrt(norm)
    return y.to(x.dtype)


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _gdn_fwd_kernel(
        x_ptr, gt_ptr, beta_ptr, y_ptr, R, C,
        BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr, BLOCK_N: tl.constexpr,
        INVERSE: tl.constexpr, IEEE: tl.constexpr,
    ):
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        rmask = rows < R
        ks = tl.arange(0, BLOCK_K)
        kmask = ks < C
        x = tl.load(
            x_ptr + rows[:, None] * C + ks[None, :],
            mask=rmask[:, None] & kmask[None, :], other=0.0,
        )
        xsq = x * x  # in x's dtype, as the TPU kernel squares
        for n0 in range(0, C, BLOCK_N):
            ns = n0 + tl.arange(0, BLOCK_N)
            nmask = ns < C
            g = tl.load(
                gt_ptr + ks[:, None] * C + ns[None, :],
                mask=kmask[:, None] & nmask[None, :], other=0.0,
            )
            if IEEE:
                norm = tl.dot(xsq, g, input_precision="ieee")
            else:
                norm = tl.dot(xsq, g)  # bf16 operands, fp32 accumulator
            b = tl.load(beta_ptr + ns, mask=nmask, other=1.0).to(tl.float32)
            norm = norm + b[None, :]
            offs = rows[:, None] * C + ns[None, :]
            omask = rmask[:, None] & nmask[None, :]
            xn = tl.load(x_ptr + offs, mask=omask, other=0.0).to(tl.float32)
            if INVERSE:
                y = xn * tl.sqrt(norm)
            else:
                y = xn * tl.rsqrt(norm)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=omask)

    return _gdn_fwd_kernel


def _launch(x, gamma, beta, inverse):
    global _KERNEL
    import triton

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gdn kernel takes fp32 or bf16, got {x.dtype}")
    rows, c = x.shape
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} do not "
            f"match C={c}"
        )
    if _KERNEL is None:
        _KERNEL = _build_kernel()
    x = x.contiguous()
    gamma_t = gamma.t().to(x.dtype).contiguous()  # (C_in, C_out)
    beta = beta.float().contiguous()
    y = torch.empty_like(x)
    block_k = max(16, triton.next_power_of_2(c))
    grid = (triton.cdiv(rows, _BLOCK_R),)
    _KERNEL[grid](
        x, gamma_t, beta, y, rows, c,
        BLOCK_R=_BLOCK_R, BLOCK_K=block_k, BLOCK_N=min(_BLOCK_N, block_k),
        INVERSE=bool(inverse), IEEE=x.dtype == torch.float32,
        # the squared tile stays live across the channel blocks: 8 warps
        # keep it at 64 fp32 registers a thread for a 64×256 tile
        num_warps=8 if block_k > 64 else 4, num_stages=1,
    )
    gdn_fused.launches += 1
    return y


class _GdnKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        return _launch(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the GDN backward on CUDA lands with training (ROADMAP A12); "
            "run the forward under torch.no_grad()"
        )


def gdn_fused(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """GDN/IGDN on (rows, C) — the counterpart of ``pallas_gdn.gdn_fused``.

    gamma: (C_out, C_in); beta: (C,).  CPU tensors take ``gdn_plain``;
    CUDA tensors launch kernel B2; any other device raises."""
    if x.device.type == "cpu":
        return gdn_plain(x, gamma, beta, inverse)
    if x.device.type != "cuda":
        raise RuntimeError(f"gdn_fused: no kernel for device {x.device}")
    return _GdnKernel.apply(x, gamma, beta, inverse)


gdn_fused.launches = 0


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
        y = gdn_fused(
            x2d, self._gamma_rp(self.gamma), self._beta_rp(self.beta),
            self.inverse,
        )
        return y.view(b, h, w, c).permute(0, 3, 1, 2)


def IGDN(num_features: int) -> GDN:
    """Reference IGDN: multiply by ``sqrt(norm)``."""
    return GDN(num_features, inverse=True)


__all__ = ["GDN", "IGDN", "gdn_fused", "gdn_plain"]
