"""Spans the benchmark records around the program's calls.

``Recorder.host`` wraps a method of a program object with the host clock
(optionally synchronising the device before and after), ``Recorder.cuda``
with a pair of CUDA events; both also open a ``torch.profiler``
``record_function`` span of the same name, which the trace's idle gaps
are named by.  Nothing is wrapped in a run without ``--trace 1``: the
timed path of the end-to-end metrics is the program's own.  The per-layer
readers (``layer_metrics/``) read what a run recorded: ``host_s[name]``
and ``cuda_ms[name]`` (one entry per call), ``values`` (numbers a driver
kept: counts, operations, bytes, the window) and ``device`` (the traced
stretch's busy and window seconds and breakdown).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import torch


class Recorder:
    def __init__(self, on: bool):
        self.on = on
        self.host_s: Dict[str, List[float]] = defaultdict(list)
        self.cuda_ms: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, list] = defaultdict(list)
        self.values: Dict[str, object] = {}
        self.device: Dict[str, object] = {}
        self._undo: list = []
        self.recording = True  # False: the wrappers open their spans and keep nothing

    def host(self, obj, attr: str, name: str, sync: bool = False) -> None:
        """Time each call of ``obj.attr`` on the host clock."""
        if not self.on:
            return
        inner = getattr(obj, attr)
        spent = self.host_s[name]

        def timed(*a, **k):
            with torch.profiler.record_function(name):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    out = inner(*a, **k)
                    if sync:
                        torch.cuda.synchronize()
                    return out
                finally:
                    if self.recording:
                        spent.append(time.perf_counter() - t0)

        self._install(obj, attr, timed)

    def cuda(self, obj, attr: str, name: str) -> None:
        """Time each call of ``obj.attr`` on the device with CUDA events."""
        if not self.on:
            return
        inner = getattr(obj, attr)
        events = self._events[name]

        def timed(*a, **k):
            with torch.profiler.record_function(name):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*a, **k)
                end.record()
                if self.recording:
                    events.append((start, end))
                return out

        self._install(obj, attr, timed)

    def _install(self, obj, attr, fn) -> None:
        had = attr in vars(obj)
        old = vars(obj).get(attr)
        setattr(obj, attr, fn)
        self._undo.append((obj, attr, had, old))

    def collect(self) -> None:
        """Read the CUDA events (after a synchronise) and unwrap every
        method."""
        if self._events:
            torch.cuda.synchronize()
        for name, pairs in self._events.items():
            self.cuda_ms[name].extend(s.elapsed_time(e) for s, e in pairs)
        self._events.clear()
        for obj, attr, had, old in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo.clear()
