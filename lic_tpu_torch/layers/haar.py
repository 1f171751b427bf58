"""Orthonormal Haar analysis and synthesis (counterpart of
``lic_tpu/layers/haar.py``), NCHW.

``haar_dwt2`` maps (B, C, H, W) to (B, 4C, H/2, W/2), the channel blocks
[LL ∥ LH ∥ HL ∥ HH] in the JAX function's order; ``haar_idwt2`` inverts it
exactly (each output is a sum of four terms times ½, exact in binary
floating point); ``haar_pyramid`` recurses on LL.  Reshapes and adds: the
JAX package runs them through XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import List

import torch


def haar_dwt2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, 4C, H/2, W/2): [LL ∥ LH ∥ HL ∥ HH]."""
    a, b = x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]
    c, d = x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]
    return torch.cat([(a + b + c + d) * 0.5, (a - b + c - d) * 0.5,
                      (a + b - c - d) * 0.5, (a - b - c + d) * 0.5], dim=1)


def haar_idwt2(y: torch.Tensor) -> torch.Tensor:
    """The inverse of ``haar_dwt2``."""
    ll, lh, hl, hh = y.chunk(4, dim=1)
    bsz, ch, h2, w2 = ll.shape
    out = y.new_empty(bsz, ch, 2 * h2, 2 * w2)
    out[:, :, 0::2, 0::2] = (ll + lh + hl + hh) * 0.5
    out[:, :, 0::2, 1::2] = (ll - lh + hl - hh) * 0.5
    out[:, :, 1::2, 0::2] = (ll + lh - hl - hh) * 0.5
    out[:, :, 1::2, 1::2] = (ll - lh - hl + hh) * 0.5
    return out


def haar_pyramid(x: torch.Tensor, levels: int = 2) -> List[torch.Tensor]:
    """The subbands of each level, each level's DWT taken of the LL before."""
    out = []
    for _ in range(levels):
        x = haar_dwt2(x)
        out.append(x)
        x = x[:, : x.shape[1] // 4]
    return out
