"""Running the harness on the CPU at a small size, for the tests.

``patched_cuda`` makes the ``torch.cuda`` calls the drivers make harmless
on a host without a card (events on the host clock, no synchronise, a
peak of 0), and ``run_small`` runs a cell through ``run.execute`` with
its mix shrunk; the profiled stretch traces the CPU only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from benchmark import run


class _Event:
    def __init__(self, enable_timing: bool = False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


@contextlib.contextmanager
def patched_cuda(monkeypatch):
    for name, fn in (("synchronize", lambda *a, **k: None),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("empty_cache", lambda *a, **k: None),
                     ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, fn)

    def profile(self, fn):
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench.traced"):
                fn()
        self.record.device = {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                              "idle_gaps": [], "cpu_events": len(prof.events())}

    monkeypatch.setattr(run.Context, "profile", profile)
    yield


def full_spec() -> dict:
    """``BENCHMARK.json`` with the cells of ``later_cells.json`` added, as a
    later PR adds them: the training and serving cells, whose drivers,
    mixes and readers are here and are tested here, but whose end-to-end
    metrics spread too widely to be bounded yet (PERF.md section 7)."""
    spec = run.spec_of()
    with open(os.path.join(os.path.dirname(__file__), "later_cells.json")) as f:
        later = json.load(f)
    return {**spec, **{k: spec[k] + later[k] for k in later}}


def run_small(workload: str, seed: int, traffic: dict, trace: int = 0,
              seconds: float = 0.5) -> dict:
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    return run.execute(args, torch.device("cpu"), traffic)
