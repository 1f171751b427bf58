"""Reading the device's activity from a ``torch.profiler`` trace.

``union_length`` and ``device_activity`` are frozen copies of
``lic_tpu_torch/tools/profile_path.py`` at commit a087453: the device is
busy where a kernel, a copy or a memset runs, and its busy time is the
union of those intervals.  ``summarize`` names the ten device operations
that took most time and the ten largest sums of idle device time by the
host span open across each gap: the innermost of the benchmark's own
``record_function`` labels around the program's calls, the program's
spans and the operators the profiler records on the host, found by time
however many host events lie between the gap and its span's start.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_activity(trace_events: List[dict]) -> Dict[str, object]:
    """From Chrome-trace events: the device's busy microseconds (union of
    kernel, copy and memset intervals), the span from the first device
    activity to the last, and the kernel time by name."""
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for ev in trace_events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((s, s + d))
        if str(ev["cat"]).lower() == "kernel":
            by_name[ev["name"]][0] += d
            by_name[ev["name"]][1] += 1
    if not spans:
        raise RuntimeError("the trace holds no device activity")
    return {
        "busy_us": union_length(spans),
        "span_us": max(e for _, e in spans) - min(s for s, _ in spans),
        "kernels": sorted(by_name.items(), key=lambda kv: -kv[1][0]),
    }


def _merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(trace_events: List[dict], t0_us: float, t1_us: float) -> Dict[str, float]:
    """Idle device seconds in [t0, t1] by the innermost host span open at
    each gap's middle: a benchmark span or an operator the host was
    launching ("outside any span" where none is).  The innermost is the
    open span that starts last (of two that start together, the later in
    (start, end, name) order); the gaps' middles only rise, so one sweep
    over the spans in that order, with a heap of those started, finds
    each."""
    dev = _merged([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in trace_events if e.get("ph") == "X"
                   and str(e.get("cat", "")).lower() in DEVICE_CATS])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in trace_events if e.get("ph") == "X"
                  and str(e.get("cat", "")).lower() in HOST_CATS)
    started: List[int] = []  # a max-heap of the started spans' indices, negated
    nxt = 0
    gaps, prev = defaultdict(float), t0_us
    for s, e in dev + [(t1_us, t1_us)]:
        s, e = max(s, t0_us), min(e, t1_us)
        if s > prev:
            mid = (prev + s) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                heapq.heappush(started, -nxt)
                nxt += 1
            while started and host[-started[0]][1] < mid:  # closed before this middle
                heapq.heappop(started)
            name = host[-started[0]][2] if started else "outside any span"
            gaps[name] += (s - prev) * 1e-6
        prev = max(prev, e)
    return gaps


def read_trace(path: str) -> List[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def summarize(events: List[dict], t0_us: float, t1_us: float) -> Dict[str, object]:
    """→ busy_s, window_s and the breakdown of a traced stretch
    [t0, t1] (profiler microseconds)."""
    inside = [e for e in events if e.get("ph") == "X" and "ts" in e
              and t0_us <= float(e["ts"]) <= t1_us]
    act = device_activity(inside)
    gaps = idle_gaps(inside, t0_us, t1_us)
    return {
        "busy_s": act["busy_us"] * 1e-6,
        "window_s": (t1_us - t0_us) * 1e-6,
        "device_ops": [[name, v[0] * 1e-6] for name, v in act["kernels"][:10]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
    }
