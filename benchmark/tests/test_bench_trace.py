"""The idle gaps of a traced stretch are named by the innermost host span
open at their middle, however many host events lie between them."""

import pytest

from benchmark import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_a_gap_is_named_by_its_span_past_thousands_of_nested_events():
    # a compress span holding 3,000 operators, then a long wait in it: the
    # device is idle from 1 to 9,000 us (the middle at 4,500.5) and from
    # 9,001 us to the end, after the span has closed
    events = [_x("user_annotation", "coder.compress", 0, 9_500),
              _x("user_annotation", "bench.traced", 0, 9_500)]
    events += [_x("cpu_op", "aten::conv2d", k, 0.5) for k in range(3_000)]
    events += [_x("kernel", "k", 0, 1), _x("kernel", "k", 9_000, 1)]
    gaps = trace.idle_gaps(events, 0, 10_000)
    # of two spans that start together, the later in (start, end, name) order
    assert dict(gaps) == pytest.approx({"coder.compress": 8_999e-6, "outside any span": 999e-6})
    summary = trace.summarize(events, 0, 10_000)
    assert summary["idle_gaps"][0][0] == "coder.compress"
    idle = sum(v for _, v in summary["idle_gaps"])
    assert idle == pytest.approx(summary["window_s"] - summary["busy_s"])
