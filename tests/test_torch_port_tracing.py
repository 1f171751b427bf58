"""The port's spans (``lic_tpu_torch.utils.profiling``) and the phases
``ChannelCoder`` records with them, on the CPU.

* spans nest by thread, a root starts a call, and self time is a span's
  duration less what its children cover;
* the ring keeps the newest spans and counts the ones it drops by name,
  and a series of samples keeps its newest values;
* a pool's tasks join the caller's call through ``parent=``;
* ``record_function`` is opened only while a profiler records;
* under ``torch.profiler`` every compress and decompress phase is in the
  Chrome trace on the caller's thread, around its operators;
* a roundtrip of two images records each phase once and one
  ``coder.compress.image`` per image, one call per root;
* the streams and reconstructions are those written without the spans.

``source_net`` with ``n_override=32`` at 64×64, random weights.
"""

import contextlib
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lic_tpu_torch.models import build_model
from lic_tpu_torch.models import compress as compress_mod
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.utils import profiling
from lic_tpu_torch.utils.profiling import Spans

torch.set_num_threads(2)

COMPRESS = ("coder.compress.launch", "coder.compress.fetch", "coder.compress.entropy")
DECOMPRESS = ("coder.decompress.entropy", "coder.decompress.launch",
              "coder.decompress.check", "coder.decompress.synthesize")


@pytest.fixture(scope="module")
def coder():
    torch.manual_seed(0)
    return ChannelCoder(build_model("source_net", device="cpu", n_override=32),
                        name="source_net")


@pytest.fixture(scope="module")
def images():
    g = torch.Generator().manual_seed(1)
    return torch.rand(2, 3, 64, 64, generator=g) * 2 - 1


def _ns(r):
    return r.end_ns - r.start_ns


def test_spans_nest_share_a_call_and_keep_self_time():
    sp = Spans()
    with sp.span("a"):
        with sp.span("b"):
            time.sleep(0.002)
        with sp.span("c"):
            pass
    with sp.span("d"):
        pass
    r = {x.name: x for x in sp.records()}
    assert r["b"].parent == r["a"].id == r["c"].parent
    assert r["a"].parent is None and r["d"].parent is None
    assert r["a"].call == r["b"].call == r["c"].call != r["d"].call
    assert len({x.thread for x in r.values()}) == 1
    stats = sp.span_stats()
    assert stats["a"]["self_s"] == pytest.approx((_ns(r["a"]) - _ns(r["b"]) - _ns(r["c"])) * 1e-9)
    assert stats["b"]["self_s"] == stats["b"]["total_s"] == stats["b"]["median_s"] >= 0.002
    assert all(s["count"] == 1 and s["dropped"] == 0 for s in stats.values())


def test_the_ring_keeps_the_newest_and_counts_what_it_drops():
    sp = Spans(capacity=4, sample_capacity=3)
    for name in ("x", "x", "y", "x", "y", "y"):
        with sp.span(name):
            pass
    for v in range(5):
        sp.sample("v", v)
    assert [r.name for r in sp.records()] == ["y", "x", "y", "y"]
    stats = sp.span_stats()
    assert (stats["x"]["count"], stats["x"]["dropped"]) == (1, 2)
    assert (stats["y"]["count"], stats["y"]["dropped"]) == (3, 0)
    assert sp.samples("v") == [2.0, 3.0, 4.0] and sp.samples("w") == []
    sp.reset()
    assert sp.records() == [] and sp.span_stats() == {} and sp.samples("v") == []


def test_a_pools_tasks_join_the_callers_call():
    sp = Spans()
    both = threading.Barrier(2, timeout=30)

    def task(parent):
        with sp.span("task", parent=parent):
            with sp.span("inner"):  # the task's span is its parent on its thread
                if parent is not None:
                    both.wait()  # the caller's two tasks overlap

    with ThreadPoolExecutor(max_workers=2) as pool:
        with sp.span("caller") as caller:
            list(pool.map(task, [caller, caller]))
        pool.submit(task, None).result()  # no parent: a call of its own
    r = sp.records()
    (root,) = [x for x in r if x.name == "caller"]
    tasks = [x for x in r if x.name == "task"]
    inner = [x for x in r if x.name == "inner"]
    assert [t.parent for t in tasks[:2]] == [root.id, root.id]
    assert {t.call for t in tasks[:2]} == {root.call} != {tasks[2].call}
    assert tasks[2].parent is None
    assert {i.parent for i in inner} == {t.id for t in tasks}
    assert root.thread == threading.get_ident() not in {t.thread for t in tasks}
    # the caller's self time is what the union of its overlapping tasks leaves
    start = min(t.start_ns for t in tasks[:2])
    end = max(t.end_ns for t in tasks[:2])
    assert sp.span_stats()["caller"]["self_s"] == pytest.approx(
        (_ns(root) - (end - start)) * 1e-9, abs=1e-12)


@pytest.mark.parametrize("recording", [False, True])
def test_record_function_is_opened_only_while_a_profiler_records(monkeypatch, recording):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    sp = Spans()
    ctx = profile(activities=[ProfilerActivity.CPU]) if recording else contextlib.nullcontext()
    with ctx:
        for _ in range(3):
            with sp.span("x"):
                pass
    assert entered == (["x"] * 3 if recording else [])
    assert len(sp.records()) == 3


def test_a_roundtrip_records_each_phase_once_per_call(coder, images):
    profiling.reset_spans()
    coder.decompress_batch(coder.compress_batch(images))
    r = profiling.records()
    names = [x.name for x in r]
    for phase in ("coder.compress", "coder.decompress") + COMPRESS + DECOMPRESS:
        assert names.count(phase) == 1, phase
    assert names.count("coder.compress.image") == 2
    roots = {x.name: x for x in r if x.parent is None}
    assert set(roots) == {"coder.compress", "coder.decompress"}
    for x in r:
        root = roots["coder.decompress" if x.name.startswith("coder.decompress") else
                     "coder.compress"]
        assert x.call == root.call, x.name
    (entropy,) = [x for x in r if x.name == "coder.compress.entropy"]
    assert {x.parent for x in r if x.name == "coder.compress.image"} == {entropy.id}
    assert profiling.samples("coder.pool.workers") == [2.0]
    assert profiling.samples("host.cpus")[0] >= 1
    (on_cpu,) = profiling.samples("coder.compress.entropy.on_cpu")
    assert 0.0 < on_cpu <= 1.05


def test_the_trace_holds_each_phase_around_its_operators(coder, images, tmp_path):
    """Each phase on the caller's thread, around an operator it runs (the
    compress's entropy phase runs none: the pool's encodes are host
    code)."""
    want = {"coder.compress.launch": "aten::convolution", "coder.compress.fetch": "aten::to",
            "coder.compress.entropy": None, "coder.decompress.entropy": "aten::permute",
            "coder.decompress.launch": "aten::convolution", "coder.decompress.check": "aten::eq",
            # g_s's _Up5 deconvs: up5's four phase convs (its plain version here)
            "coder.decompress.synthesize": "aten::conv2d"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coder.decompress_batch(coder.compress_batch(images))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tid = threading.get_native_id()
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == tid]
    for phase, op in want.items():
        (ev,) = [e for e in events if e.get("name") == phase and e.get("ph") == "X"]
        assert ev["cat"] == "user_annotation" and ev["tid"] == tid, phase
        inside = {o["name"] for o in ops
                  if ev["ts"] <= o["ts"] and o["ts"] + o["dur"] <= ev["ts"] + ev["dur"]}
        assert (op in inside) if op else not inside, (phase, sorted(inside))


def test_the_streams_are_those_written_without_spans(coder, images, monkeypatch):
    blobs = coder.compress_batch(images)
    rec = coder.decompress_batch(blobs)
    monkeypatch.setattr(compress_mod, "span", lambda name, parent=None: contextlib.nullcontext())
    plain = coder.compress_batch(images)
    assert plain == blobs
    assert torch.equal(coder.decompress_batch(plain), rec)
