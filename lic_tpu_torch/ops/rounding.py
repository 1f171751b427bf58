"""Rounding quantizers (forward only).

Counterpart of ``lic_tpu/ops/rounding.py``.  ``torch.round`` and
``jnp.round`` both round half to even, so the forward values agree
bit-exactly in fp32.  The identity (straight-through) gradients come with
training.
"""

from __future__ import annotations

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """``round(x)``; the straight-through gradient lands with training."""
    return torch.round(x)


bypass_round = ste_round


def quantize_ste_offset(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``ste_round(x - offset) + offset`` (medians-offset quantization)."""
    return ste_round(x - offset) + offset
