"""Microseconds per serial step of a neural-syntax decode: the median of
the program's span ``coder.decompress.wavefront`` over the median of its
sample ``coder.wavefront.steps`` (T, the loop's steps: 110 at a 32 x 48
latent).  The host's cost of one step, all of whose launches wait on the
step before."""

from benchmark.layer_metrics._wavefront import sample_median, span_median_s


def read(rec):
    s = span_median_s(rec, "coder.decompress.wavefront")
    steps = sample_median(rec, "coder.wavefront.steps")
    return None if s is None or not steps else 1e6 * s / steps
