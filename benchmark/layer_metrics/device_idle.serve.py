"""The share of a traced stretch of the open loop in which no kernel, copy
or memset ran on the card, %."""

from benchmark.layer_metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
