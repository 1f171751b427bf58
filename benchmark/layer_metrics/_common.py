"""Arithmetic the readers share."""

from __future__ import annotations

from typing import Optional

from benchmark.roofline import PEAK_TF32X3, bound_s


def rate(rec, span: str, unit_key: str) -> Optional[float]:
    """Units of ``values[unit_key]`` per call of ``span`` over the summed
    host time of those calls."""
    spent = rec.host_s.get(span)
    if not spent or unit_key not in rec.values:
        return None
    return rec.values[unit_key] * len(spent) / sum(spent)


def roofline_pct(rec, span: str, stage: str) -> Optional[float]:
    """The stage's least time on the card (its operations at the 3xTF32
    rate or its bytes at the HBM rate) over its mean CUDA-event time, %."""
    ms = rec.cuda_ms.get(span)
    flops = rec.values.get("flops", {}).get(stage)
    if not ms or flops is None:
        return None
    mean_s = sum(ms) / len(ms) / 1e3
    return 100.0 * bound_s(flops, rec.values[f"{stage}_bytes"]) / mean_s


def idle_pct(rec) -> Optional[float]:
    dev = rec.device
    if not dev or not dev.get("window_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def mfu_pct(rec, flops_key: str, count_key: str) -> Optional[float]:
    """Operations of the work the window finished over its seconds at the
    3xTF32 peak, %."""
    v = rec.values
    if flops_key not in v or count_key not in v or not v.get("window_s"):
        return None
    return 100.0 * v[flops_key] * v[count_key] / (v["window_s"] * PEAK_TF32X3)
