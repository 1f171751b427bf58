"""g_a's share of its roofline, %: ``model.analyze`` timed by CUDA events
per pass, against its operations and bytes on the reference."""

from benchmark.layer_metrics._common import roofline_pct


def read(rec):
    return roofline_pct(rec, "analyze", "analyze")
