"""Rounding and additive-noise quantizers.

Counterpart of ``lic_tpu/ops/rounding.py``.  ``torch.round`` and
``jnp.round`` both round half to even.  ``ste_round`` is the JAX package's
``x + stop_gradient(round(x) - x)``: forward ``round(x)`` (the sum is
exact), backward identity; where autograd does not need the gradient it
is ``torch.round`` itself, the same values.

The train-time noise is drawn through a ``noise_fn(shape, dtype, device)``
that returns U(-½, ½) samples: ``uniform_noise(generator)`` by default, so
that a caller (a parity test) can hand in any other draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

NoiseFn = Callable[[Sequence[int], torch.dtype, torch.device], torch.Tensor]


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with the identity (straight-through) gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return x + (torch.round(x) - x).detach()
    return torch.round(x)


# same forward and backward; the name mirrors the reference API
bypass_round = ste_round


def quantize_ste_offset(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``ste_round(x - offset) + offset`` (medians-offset quantization)."""
    return ste_round(x - offset) + offset


def uniform_noise(generator: Optional[torch.Generator] = None) -> NoiseFn:
    """A ``noise_fn`` drawing ``torch.rand(...) - 0.5`` from ``generator``
    (which must live on the device asked for; None: torch's default)."""

    def draw(shape, dtype, device):
        return torch.rand(tuple(shape), generator=generator, dtype=dtype, device=device) - 0.5

    return draw


def additive_noise(x: torch.Tensor, noise_fn: NoiseFn) -> torch.Tensor:
    """``x + U(-½, ½)``, the train-mode relaxation."""
    return x + noise_fn(x.shape, x.dtype, x.device)


def noise_quant(
    x: torch.Tensor, *, noise_fn: Optional[NoiseFn] = None, training: bool = False,
    table_range: int = 128,
) -> torch.Tensor:
    """Train: ``x + U(-½, ½)``; eval: ``floor(x + ½)``; clamped to
    ``[-table_range, table_range - 1]``.  No model path calls it (as in the
    JAX package, where it is kept for component parity)."""
    if training:
        if noise_fn is None:
            raise ValueError("noise_quant(training=True) needs a noise_fn")
        x_quant = additive_noise(x, noise_fn)
    else:
        x_quant = torch.floor(x + 0.5)
    return torch.clamp(x_quant, -table_range, table_range - 1)
