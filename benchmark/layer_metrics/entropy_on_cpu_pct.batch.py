"""The share of the compress's rANS tasks' wall time that their threads
spent on a CPU, %: the program's sample
``coder.compress.entropy.on_cpu`` (per call, the tasks' summed
``time.thread_time()`` over their summed wall time) times 100, the median
over the process's calls.  Below 100 where a task was descheduled or
waited for the interpreter lock.  Nothing where the program records no
such sample."""

import statistics


def read(rec):
    if not rec.values.get("passes"):
        return None
    try:
        from lic_tpu_torch.utils.profiling import samples
    except ImportError:  # a program without spans
        return None
    v = samples("coder.compress.entropy.on_cpu")
    return 100.0 * statistics.median(v) if v else None
