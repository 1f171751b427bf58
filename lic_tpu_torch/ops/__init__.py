"""Bound and rounding ops (counterpart of ``lic_tpu.ops``), forward only."""

from .bounds import NonNegativeParametrizer, lower_bound, upper_bound
from .rounding import bypass_round, quantize_ste_offset, ste_round

__all__ = [
    "NonNegativeParametrizer",
    "lower_bound",
    "upper_bound",
    "bypass_round",
    "quantize_ste_offset",
    "ste_round",
]
