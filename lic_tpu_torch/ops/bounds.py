"""Bound operators and the non-negative parametrizer.

Counterpart of ``lic_tpu/ops/bounds.py``.  ``lower_bound`` is ``max(x,
bound)`` whose backward passes the incoming gradient where ``x >= bound``
or ``g < 0`` (a step that moves x back toward the feasible region), and
``upper_bound`` the mirror image; both are bit-exact with the JAX
``custom_vjp`` in fp32.  Where autograd does not need the gradient (no
grad mode, or x not requiring grad) they are the plain ``clamp``.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, max=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x <= ctx.bound) | (g > 0), g, torch.zeros_like(g)), None


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` with the straight-through gradient above."""
    return _LowerBound.apply(x, bound) if _differentiated(x) else torch.clamp(x, min=bound)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(x, bound)`` with the mirrored straight-through gradient."""
    return _UpperBound.apply(x, bound) if _differentiated(x) else torch.clamp(x, max=bound)


class NonNegativeParametrizer:
    """``init: sqrt(max(x + ped, ped))``; ``apply: lower_bound(x)**2 - ped``
    with ``ped = reparam_offset**2`` (``lic_tpu/ops/bounds.py:66-87``)."""

    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2 ** -18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset ** 2
        self.bound = (self.minimum + self.reparam_offset ** 2) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        # sqrt in float64, rounded once to x's dtype: correctly rounded,
        # as XLA's, where torch's vectorized fp32 CPU sqrt is off by one ulp
        # on some inputs
        v = torch.clamp(x + self.pedestal, min=self.pedestal)
        return torch.sqrt(v.double()).to(x.dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return lower_bound(x, self.bound) ** 2 - self.pedestal
