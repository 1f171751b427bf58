"""Target-bitrate rate control over variable-rate (gain-unit) models
(counterpart of ``lic_tpu/serving/rate_control.py:46-103``).

A gain-unit model spans a continuous family of rates from one set of
weights, and its bpp rises with the continuous rate index (the log-spaced
gain-ramp init and the exponential interpolation, ``models.codec``), so a
target bpp is found by bisection on the estimated bpp: one eval forward
per probe, no entropy coding.  Feed the rate to
``ChannelCoder.compress(x, rate=...)``; it rides the bitstream header.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..data.pad import pad_to_multiple

__all__ = ["solve_rate_for_bpp"]


@torch.no_grad()
def solve_rate_for_bpp(
    model,
    x: torch.Tensor,
    target_bpp: float,
    *,
    tol: float = 0.02,
    max_iters: int = 8,
) -> Tuple[float, float]:
    """The continuous gain-unit rate whose estimated bpp hits
    ``target_bpp`` on this image.

    x: (1, 3, H, W) in [−1, 1], any size: padded inside, the bpp
    renormalized to the true pixels as ``evaluation.evaluate_image`` does;
    it runs on the model's device.

    Returns ``(rate, est_bpp)``.  Targets outside the model's span clamp
    to the nearest end (rate 0 or K − 1): compare ``est_bpp`` with
    ``target_bpp`` to see the clamp.  ``tol`` is relative: the search
    stops when |est − target| ≤ tol·target, or after ``max_iters``
    probes."""
    K = int(model.cfg.gain_units)
    if K < 2:
        raise ValueError(
            "target-bpp rate control needs a variable-rate checkpoint "
            f"(cfg.gain_units >= 2, got {K}) — e.g. the source_net_vr preset"
        )
    if target_bpp <= 0:
        raise ValueError(f"target_bpp must be positive, got {target_bpp}")
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"expected one (1, 3, H, W) image, got {tuple(x.shape)}")

    device = next(model.parameters()).device
    x = x.to(device, torch.float32, memory_format=torch.channels_last)
    padded, (h, w) = pad_to_multiple(x)
    # the model's bpp is over the padded pixels; report it per true pixel
    scale = (padded.shape[2] * padded.shape[3]) / (h * w)

    def est(rate: float) -> float:
        return float(model(padded, rate=rate).bpp) * scale

    lo, hi = 0.0, float(K - 1)
    b_lo, b_hi = est(lo), est(hi)
    if target_bpp <= b_lo:
        return lo, b_lo
    if target_bpp >= b_hi:
        return hi, b_hi

    mid, b_mid = lo, b_lo
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        b_mid = est(mid)
        if abs(b_mid - target_bpp) <= tol * target_bpp:
            break
        if b_mid < target_bpp:
            lo = mid
        else:
            hi = mid
    return mid, b_mid
