"""Milliseconds a ``compress_batch`` spends enqueuing its device passes
(padding, the upload, g_a, the hyper encoder, syntax and the slice
chain): the program's span ``coder.compress.launch`` on the host clock,
the median over the process's calls.  Nothing where the program records
no such span."""


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    s = span_stats().get("coder.compress.launch")
    return 1e3 * s["median_s"] if s and s["count"] else None
