"""Bound operators and the non-negative parametrizer (forward only).

Counterpart of ``lic_tpu/ops/bounds.py``.  The straight-through gradients
of ``lower_bound``/``upper_bound`` come with training; here they are the
plain ``max``/``min`` the eval path needs.
"""

from __future__ import annotations

import torch


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)``."""
    return torch.clamp(x, min=bound)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(x, bound)``."""
    return torch.clamp(x, max=bound)


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
