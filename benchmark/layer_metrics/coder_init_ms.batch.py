"""Milliseconds of ``ChannelCoder``'s construction: the program's span
``coder.init`` (host clock; its children the host pmf table, the host
rANS library and the device rANS tables), the median over the process's
coders.  Nothing where the program records no such span."""


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get("coder.init")
    return 1e3 * s["median_s"] if s and s["count"] else None
