"""Microseconds of one decode step's drain: the program's span
``coder.wavefront.drain`` (``rans_drain``, kernel B1's wrapper and launch
from the device-memory table, and the scatter of the step's values) on
the host clock, the median over the process's calls."""

from benchmark.layer_metrics._wavefront import span_median_s


def read(rec):
    s = span_median_s(rec, "coder.wavefront.drain")
    return None if s is None else 1e6 * s
