"""The wait for the next batch of ``train_iterator``, ms: host clock around
``next(iterator)``, the mean over the window's steps."""


def read(rec):
    s = rec.host_s.get("input_wait")
    return 1e3 * sum(s) / len(s) if s else None
