"""Layers (counterpart of ``lic_tpu.layers``): convs with kernels B3/B6,
GDN with kernel B2, residual blocks, window attention with kernels B4/B5,
the Swin blocks of ``SWAtten``, the latent U-Nets' ``SpatialTransformer``."""

from .blocks import (
    AttentionBlock,
    ResidualBlock,
    ResidualBlock3_5,
    ResidualBlock3x3,
    ResidualBlock5x5,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    ResidualBottleneck,
    ResidualUnit,
)
from .conv import (
    Conv2d,
    ConvTranspose2d,
    DepthwiseConv2d,
    Linear,
    SubpelConv2d,
    gelu,
    variance_scaling_,
)
from .conv_direct import conv5s2, conv5s2_plain, convk_s1, convk_s1_plain, up5, up5_plain
from .gdn import GDN, GDN1, IGDN, gdn_fused, gdn_plain
from .spatial_transformer import (
    GEGLU,
    BasicTransformerBlock,
    CrossAttention,
    FeedForward,
    SpatialTransformer,
)
from .swin import WMSA, SwinBlock, SwinTransformerBlock, SWAtten
from .win_attention import WinBasedAttention, WindowAttention, WinNoShiftAttention
from .window_attn import (
    wba_plain,
    wba_proj_plain,
    window_attention,
    window_attention_proj,
)

__all__ = [
    "AttentionBlock",
    "BasicTransformerBlock",
    "CrossAttention",
    "FeedForward",
    "GEGLU",
    "SpatialTransformer",
    "Conv2d",
    "ConvTranspose2d",
    "DepthwiseConv2d",
    "Linear",
    "SubpelConv2d",
    "gelu",
    "variance_scaling_",
    "conv5s2",
    "conv5s2_plain",
    "convk_s1",
    "convk_s1_plain",
    "up5",
    "up5_plain",
    "GDN",
    "GDN1",
    "IGDN",
    "gdn_fused",
    "gdn_plain",
    "ResidualBlock",
    "ResidualBlock3_5",
    "ResidualBlock3x3",
    "ResidualBlock5x5",
    "ResidualBlockUpsample",
    "ResidualBlockWithStride",
    "ResidualBottleneck",
    "ResidualUnit",
    "SWAtten",
    "SwinBlock",
    "SwinTransformerBlock",
    "WMSA",
    "WinBasedAttention",
    "WindowAttention",
    "WinNoShiftAttention",
    "wba_plain",
    "wba_proj_plain",
    "window_attention",
    "window_attention_proj",
]
