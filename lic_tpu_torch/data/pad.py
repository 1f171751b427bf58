"""Padding to a multiple of the transform stride (counterpart of
``lic_tpu/data/pad.py:21-55``), NCHW.  Only the default replicate mode is
ported: it is the one the codec uses ('ones' and 'zeros' serve the JAX
package's reference-parity eval, ROADMAP A13)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def padded_size(h: int, w: int, multiple: int = 64) -> Tuple[int, int]:
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    return ph, pw


def pad_to_multiple(
    x: torch.Tensor, multiple: int = 64
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Replicate-pad (B, C, H, W) on the bottom/right to multiples of
    ``multiple``.  Returns (padded, (orig_h, orig_w))."""
    h, w = x.shape[2], x.shape[3]
    ph, pw = padded_size(h, w, multiple)
    if (ph, pw) == (h, w):
        return x, (h, w)
    return F.pad(x, (0, pw - w, 0, ph - h), mode="replicate"), (h, w)


def unpad(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = size
    return x[:, :, :h, :w]
