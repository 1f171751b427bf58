"""Images per batch the service formed (``compress_batch`` /
``decompress_batch`` calls in the window), the mean."""


def read(rec):
    b = rec.values.get("batch_sizes")
    return sum(b) / len(b) if b else None
