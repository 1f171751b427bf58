"""Milliseconds a ``compress_batch`` spends copying the symbols, rows, z
and syntax to the host, the first copy waiting for the device passes to
end: the program's span ``coder.compress.fetch`` on the host clock, the
median over the process's calls.  Near 0 means the compress is bound by
its launches.  Nothing where the program records no such span."""


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get("coder.compress.fetch")
    return 1e3 * s["median_s"] if s and s["count"] else None
