"""The 95th percentile of each request's wait in the service's queue, ms:
from when it was due to the start of the ``compress_batch`` /
``decompress_batch`` call that took it (host clock; the benchmark's
wrapper records each call the service makes)."""

import numpy as np


def read(rec):
    w = rec.values.get("queue_waits_ms")
    return float(np.percentile(w, 95, method="higher")) if w else None
