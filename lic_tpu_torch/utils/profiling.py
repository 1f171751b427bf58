"""Spans and samples inside the port (counterpart of
``lic_tpu/utils/profiling.py``: ``span``, ``span_stats``, ``reset_spans``).

``span(name)`` times a block on ``time.perf_counter_ns`` and keeps it in a
bounded ring in memory: its name, start and end, its own id, its parent
span, the call it belongs to and its thread.  A thread-local stack gives
each span the span open around it on its thread as parent; a span with no
parent starts a new call, and every span under it shares that call's id.
Work handed to another thread passes the caller's span as ``parent=``, so
its spans join the caller's call.  When the ring is full the oldest span
is dropped and counted under its name.

While a ``torch.profiler`` is recording, a span also opens
``torch.profiler.record_function(name)``, so the phase appears in the
Chrome trace beside the card's kernels, on the profiler's clock.  Without
a profiler it opens none (an idle ``record_function`` costs about ten
times the span itself).  Only the thread that started the profiler has its
annotations traced, unless the profiler was built with
``profile_all_threads``.

``sample(name, value)`` keeps a bounded series of numbers per name, the
oldest dropped first.  ``span_stats()`` sums the spans by name,
``samples(name)`` gives a series, ``records()`` the spans themselves.  The
records are always on; ``torch.profiler``'s Chrome trace is their only
exporter.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CAPACITY = 65536
SAMPLE_CAPACITY = 4096


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the parent span's id
    call: int
    thread: int


class Span:
    """One open span; ``Spans.span`` makes it, ``with`` opens and closes it."""

    __slots__ = ("_owner", "name", "parent", "id", "call", "start_ns", "end_ns", "_annotation")

    def __init__(self, owner: "Spans", name: str, parent: Optional["Span"]):
        self._owner, self.name, self.parent = owner, name, parent

    def __enter__(self) -> "Span":
        owner = self._owner
        stack = owner._local.stack
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(owner._ids)
        self.call = self.parent.call if self.parent is not None else next(owner._calls)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        else:
            self._annotation = None
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        owner, local = self._owner, self._owner._local
        local.stack.pop()
        parent = self.parent
        owner._keep((self.name, self.start_ns, self.end_ns, self.id,
                     None if parent is None else parent.id, self.call, local.thread))


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []
        self.thread = threading.get_ident()


class Spans:
    """A ring of spans and a series of samples per name."""

    def __init__(self, capacity: int = SPAN_CAPACITY, sample_capacity: int = SAMPLE_CAPACITY):
        self._ring: Deque[tuple] = deque()
        self._capacity = capacity
        self._dropped: Dict[str, int] = defaultdict(int)
        self._samples: Dict[str, Deque[float]] = {}
        self._sample_capacity = sample_capacity
        self._lock = threading.Lock()
        self._local = _Local()
        self._ids = itertools.count(1)
        self._calls = itertools.count(1)

    def _keep(self, rec: tuple) -> None:
        # an append is atomic; the lock is taken only to drop the oldest
        ring = self._ring
        ring.append(rec)
        if len(ring) > self._capacity:
            with self._lock:
                while len(ring) > self._capacity:
                    self._dropped[ring.popleft()[0]] += 1

    def span(self, name: str, parent: Optional[Span] = None) -> Span:
        """A context manager timing its block as the span ``name``;
        ``parent``: the caller's span, for work handed to another thread."""
        return Span(self, name, parent)

    def sample(self, name: str, value: float) -> None:
        with self._lock:
            series = self._samples.get(name)
            if series is None:
                series = self._samples[name] = deque(maxlen=self._sample_capacity)
            series.append(float(value))

    def samples(self, name: str) -> List[float]:
        with self._lock:
            return list(self._samples.get(name, ()))

    def records(self) -> List[SpanRecord]:
        rows = list(self._ring)  # one C call: no append lands halfway
        return [SpanRecord(*r) for r in rows]

    def span_stats(self) -> Dict[str, Dict[str, float]]:
        """Per name: ``count``, ``total_s``, ``median_s``, ``self_s`` (each
        span's duration less the part of it its children cover, summed)
        and ``dropped`` (spans the ring let go)."""
        recs = self.records()
        with self._lock:
            dropped = dict(self._dropped)
        children: Dict[int, List[SpanRecord]] = defaultdict(list)
        for r in recs:
            if r.parent is not None:
                children[r.parent].append(r)
        by_name: Dict[str, List[SpanRecord]] = defaultdict(list)
        for r in recs:
            by_name[r.name].append(r)
        out = {}
        for name in by_name.keys() | dropped.keys():
            rs = by_name.get(name, [])
            secs = [(r.end_ns - r.start_ns) * 1e-9 for r in rs]
            own = sum(r.end_ns - r.start_ns - _covered(r, children.get(r.id, ())) for r in rs)
            out[name] = {"count": len(rs), "total_s": sum(secs),
                         "median_s": statistics.median(secs) if secs else 0.0,
                         "self_s": own * 1e-9, "dropped": dropped.get(name, 0)}
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped.clear()
            self._samples.clear()


def _covered(parent: SpanRecord, kids) -> int:
    """Nanoseconds of ``parent`` that the union of ``kids`` covers."""
    total, end = 0, parent.start_ns
    for s, e in sorted((max(k.start_ns, parent.start_ns), min(k.end_ns, parent.end_ns))
                       for k in kids):
        s = max(s, end)
        if e > s:
            total += e - s
            end = e
    return total


_SPANS = Spans()
span = _SPANS.span
sample = _SPANS.sample
samples = _SPANS.samples
records = _SPANS.records
span_stats = _SPANS.span_stats
reset_spans = _SPANS.reset
