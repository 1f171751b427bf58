"""Milliseconds of a ``compress_batch``'s host entropy coding, the thread
pool's z and y encodes and the packing of each stream, while the card has
nothing queued: the program's span ``coder.compress.entropy`` on the host
clock, the median over the process's calls.  Nothing where the program
records no such span."""


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get("coder.compress.entropy")
    return 1e3 * s["median_s"] if s and s["count"] else None
