"""Bound and rounding ops (counterpart of ``lic_tpu.ops``), with the JAX
package's straight-through gradients."""

from .bounds import NonNegativeParametrizer, lower_bound, upper_bound
from .rounding import (
    additive_noise,
    bypass_round,
    noise_quant,
    quantize_ste_offset,
    ste_round,
    uniform_noise,
)

__all__ = [
    "NonNegativeParametrizer",
    "lower_bound",
    "upper_bound",
    "additive_noise",
    "bypass_round",
    "noise_quant",
    "quantize_ste_offset",
    "ste_round",
    "uniform_noise",
]
