"""Milliseconds of a ``decompress_batch``'s host work before its first
device pass: the headers, the z decodes, the payloads' parse and
stacking: the program's span ``coder.decompress.entropy`` on the host
clock, the median over the process's calls.  Nothing where the program
records no such span."""


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get("coder.decompress.entropy")
    return 1e3 * s["median_s"] if s and s["count"] else None
