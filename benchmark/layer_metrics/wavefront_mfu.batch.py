"""The decode's wavefront loop's share of its roofline, %: one pass of
the context head over the batch's real latent positions
(``context_flops``, counted on the reference; the coder's padded slots
not counted) over the median seconds of the program's span
``coder.decompress.wavefront``, at the 3xTF32 peak."""

from benchmark.layer_metrics._wavefront import span_median_s
from benchmark.roofline import PEAK_TF32X3


def read(rec):
    s = span_median_s(rec, "coder.decompress.wavefront")
    flops = rec.values.get("context_flops")
    return None if s is None or flops is None else 100.0 * flops / (s * PEAK_TF32X3)
