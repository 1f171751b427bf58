"""What the wavefront readers share: the program's spans and samples of
the neural-syntax coder's wavefront loop (``ChannelCoder._wavefronts``),
each the median over the process's calls, or None where the run recorded
nothing (an untraced run, or a program without them)."""

from __future__ import annotations

import statistics
from typing import Optional


def span_median_s(rec, name: str) -> Optional[float]:
    """The median seconds of the program's span ``name``."""
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get(name)
    return s["median_s"] if s and s["count"] else None


def sample_median(rec, name: str) -> Optional[float]:
    """The median of the program's sample series ``name``."""
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import samples
    except ImportError:
        return None
    v = samples(name)
    return statistics.median(v) if v else None
