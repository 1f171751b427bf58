"""Entropy models (counterpart of ``lic_tpu.entropy``), eval side."""

from .factorized import EntropyBottleneck
from .gaussian import GaussianConditional, GaussianModel

__all__ = ["EntropyBottleneck", "GaussianConditional", "GaussianModel"]
