"""Data helpers (counterpart of ``lic_tpu.data``): padding, and synthetic
images made from a seed."""

from .pad import pad_to_multiple, padded_size, unpad
from .synthetic import smooth_images

__all__ = ["pad_to_multiple", "padded_size", "smooth_images", "unpad"]
