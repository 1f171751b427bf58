"""Conditional Gaussian entropy models, eval side.

Counterpart of ``lic_tpu/entropy/gaussian.py:29-116``:

* ``GaussianModel`` — the reference's CDF-difference likelihood
  ``Φ((x-μ+½)/σ) − Φ((x-μ-½)/σ)`` clamped from below;
* ``GaussianConditional`` — CompressAI semantics: scale lower-bounded at
  0.11, erfc-based standardized cumulative, mean-offset rounding at eval,
  likelihood lower-bounded at 1e-9.

Both are pure functions of (inputs, scales, means), with no parameters.
In training ``GaussianConditional`` adds U(-½, ½) noise (the ``"noise"``
quantize mode) drawn by a ``noise_fn``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.bounds import lower_bound
from ..ops.rounding import NoiseFn, additive_noise

_SQRT2 = math.sqrt(2.0)
_SCALE_BOUND = 0.11
_LIKELIHOOD_BOUND = 1e-9
_MODEL_LIKELIHOOD_BOUND = 1e-8  # the reference GaussianModel's clamp


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / _SQRT2))


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x / _SQRT2)


class GaussianModel:
    """Reference ``GaussianModel``: likelihood of the unit-bin integral."""

    def __call__(self, inputs, sigma, mu) -> torch.Tensor:
        upper = _normal_cdf((inputs - mu + 0.5) / sigma)
        lower = _normal_cdf((inputs - mu - 0.5) / sigma)
        return torch.clamp(upper - lower, min=_MODEL_LIKELIHOOD_BOUND)


class GaussianConditional:
    """CompressAI-semantics conditional Gaussian (eval mode)."""

    def likelihood(
        self, inputs: torch.Tensor, scales: torch.Tensor, means: torch.Tensor
    ) -> torch.Tensor:
        scales = lower_bound(scales, _SCALE_BOUND)
        values = torch.abs(inputs - means)
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def __call__(
        self, inputs: torch.Tensor, scales: torch.Tensor, means: torch.Tensor,
        training: bool = False, noise_fn: Optional[NoiseFn] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (outputs, likelihood): eval rounds mean-offset, training adds
        U(-½, ½) noise from ``noise_fn``."""
        if training:
            if noise_fn is None:
                raise ValueError("GaussianConditional(training=True) needs a noise_fn")
            outputs = additive_noise(inputs, noise_fn)
        else:
            outputs = torch.round(inputs - means) + means
        lik = lower_bound(
            self.likelihood(outputs, scales, means), _LIKELIHOOD_BOUND
        )
        return outputs, lik
