"""Milliseconds of a neural-syntax decode's wavefront loop: the program's
span ``coder.decompress.wavefront`` (each of its T steps: the patches'
gather, the context head, the rows, one B1 drain and the scatter) on the
host clock, the median over the process's calls."""

from benchmark.layer_metrics._wavefront import span_median_s


def read(rec):
    s = span_median_s(rec, "coder.decompress.wavefront")
    return None if s is None else 1e3 * s
