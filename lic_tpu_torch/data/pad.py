"""Padding to a multiple of the transform stride (counterpart of
``lic_tpu/data/pad.py:21-55``), NCHW.

``pad_to_multiple`` takes the JAX package's three modes: 'replicate' (the
default; the codec and the eval use it), 'ones' (the reference eval's
literal padding, ``eval_net.py:68-81``) and 'zeros'.  Metrics are taken
on the unpadded region through ``unpad``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def padded_size(h: int, w: int, multiple: int = 64) -> Tuple[int, int]:
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    return ph, pw


def pad_to_multiple(
    x: torch.Tensor, multiple: int = 64, mode: str = "replicate"
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad (B, C, H, W) on the bottom/right to multiples of ``multiple``.
    Returns (padded, (orig_h, orig_w)); an unknown ``mode`` raises
    ``ValueError`` where the image needs padding, as in the JAX package."""
    h, w = x.shape[2], x.shape[3]
    ph, pw = padded_size(h, w, multiple)
    if (ph, pw) == (h, w):
        return x, (h, w)
    pads = (0, pw - w, 0, ph - h)
    if mode == "replicate":
        out = F.pad(x, pads, mode="replicate")
    elif mode == "ones":
        out = F.pad(x, pads, value=1.0)
    elif mode == "zeros":
        out = F.pad(x, pads)
    else:
        raise ValueError(mode)
    return out, (h, w)


def unpad(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = size
    return x[:, :, :h, :w]
