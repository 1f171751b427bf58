"""Layers (counterpart of ``lic_tpu.layers``): convs, GDN with kernel B2."""

from .conv import Conv2d, ConvTranspose2d, Linear, gelu, variance_scaling_
from .gdn import GDN, IGDN, gdn_fused, gdn_plain

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "Linear",
    "gelu",
    "variance_scaling_",
    "GDN",
    "IGDN",
    "gdn_fused",
    "gdn_plain",
]
