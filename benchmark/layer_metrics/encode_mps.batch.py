"""Megapixels per second of ``ChannelCoder.compress_batch``: host clock
around each call, the device synchronised before and after."""

from benchmark.layer_metrics._common import rate


def read(rec):
    return rate(rec, "compress_batch", "mp_per_batch")
