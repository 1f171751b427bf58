"""Operation and byte counts, and the H100's published peaks.

The peaks and the byte arithmetic are frozen copies of ``chip_smoke.py``
at commit a087453 (``PEAK_TF32X3``, ``PEAK_BYTES``, ``_nbytes``,
``_roofline``): NVIDIA's data sheet for the H100 SXM, dense.  fp32 work
that has to be as exact as fp32 is bounded at the 3xTF32 rate (495/3
TFLOP/s), the fastest way the card computes it.  Operations are what
``torch.utils.flop_counter.FlopCounterMode`` counts (convolutions and
matrix products, each multiply-add two) on the benchmark's reference on
the ``meta`` device: they depend on the shapes alone, so they count the
same work whatever implements it.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_TF32X3 = 495e12 / 3
PEAK_BYTES = 3.35e12


def nbytes(*ts) -> int:
    """Bytes of the tensors given (None skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def param_bytes(modules: Iterable[torch.nn.Module]) -> int:
    return sum(nbytes(*m.parameters()) for m in modules)


def count_flops(fn: Callable[[], object]) -> int:
    """The operations ``fn`` runs (forward, and backward where it calls
    one), as ``FlopCounterMode`` counts them."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def bound_s(flops: float, n_bytes: float, peak: float = PEAK_TF32X3) -> float:
    """The least time the card could take: operations over ``peak`` or
    bytes over the HBM rate, the larger."""
    return max(flops / peak, n_bytes / PEAK_BYTES)
