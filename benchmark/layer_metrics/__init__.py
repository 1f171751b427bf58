"""One reader per per-layer metric, named as the metric: ``read(record)``
returns the metric's value from what the run recorded
(``benchmark.spans.Recorder``), or None where the run recorded nothing it
reads (the harness then leaves the metric out)."""
