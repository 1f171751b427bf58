"""Traffic kind ``serve_open``: an image service under an open loop.

``CodecService(max_batch, max_wait_ms)`` over the configuration's model;
requests arrive at ``rate_per_s`` for ``--seconds``, whether or not earlier
ones have finished: a ``decompress_share`` of them decode a stream coded at
set-up, the rest compress an image, of the ``sizes`` in the ratio of
``size_weights`` (each from a pool of ``pool`` seeded images per size).
Every seed gets the same multiset of gaps between arrivals (the quantiles
of the exponential distribution at the rate: Poisson arrivals) and the
same counts of kinds and sizes, in an order of its own.

End to end: ``serve_p95_ms``, the 95th percentile over all requests of the
window of the time from when each was due to when its future resolved; a
refused or failed request counts at the wait's horizon (the window's end
plus ``drain_s``), past any limit.  ``latency_limit_ms`` is the limit the
knee was found under (``benchmark/tools/knee.py``).

The check: a sample of the finished requests drawn from the seed, each
decode (a compress request's stream decoded by the program after the
window) judged against the reference's eval forward of its image, as
``benchmark.compare`` says.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from .. import compare, system
from ..images import smooth_images


def schedule(p: dict, seed: int, seconds: float):
    """→ list of (due offset s, kind 'c' | 'd', size index, pool index)."""
    rate = float(p["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(seed)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    due = np.cumsum(gaps)  # the last is due before n / rate, the window's end
    n_dec = int(round(n * float(p["decompress_share"])))
    kinds = np.array(["d"] * n_dec + ["c"] * (n - n_dec))
    rng.shuffle(kinds)
    wts = np.asarray(p["size_weights"], np.float64)
    counts = np.floor(n * wts / wts.sum()).astype(int)
    counts[0] += n - counts.sum()
    sizes = np.repeat(np.arange(len(wts)), counts)
    rng.shuffle(sizes)
    pool_idx = rng.integers(0, int(p["pool"]), n)
    return [(float(due[i]), str(kinds[i]), int(sizes[i]), int(pool_idx[i])) for i in range(n)]


def make_pool(p: dict, seed: int, device):
    """Per size: the pool's images, (P, 3, H, W) on the device."""
    rng = np.random.default_rng(seed + 1)
    return [smooth_images(rng, int(p["pool"]), h, w, device) for h, w in p["sizes"]]


class OpenLoop:
    """One open-loop run: submits each request when it is due and records
    when each future resolves."""

    def __init__(self, svc, sched, images, streams):
        self.svc, self.sched = svc, sched
        self.images, self.streams = images, streams  # [size][pool] numpy HWC / bytes
        n = len(sched)
        self.done = [None] * n
        self.sent = [None] * n
        self.futures = [None] * n
        self.refused = [False] * n

    def run(self, t0: float) -> None:
        for i, (due, kind, s, k) in enumerate(self.sched):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.sent[i] = time.perf_counter()
            try:
                if kind == "c":
                    fut = self.svc.submit_compress(self.images[s][k])
                else:
                    fut = self.svc.submit_decompress(self.streams[s][k])
            except RuntimeError:
                self.refused[i] = True
                continue
            fut.add_done_callback(lambda f, i=i: self.done.__setitem__(i, time.perf_counter()))
            self.futures[i] = fut

    def wait(self, horizon: float) -> None:
        for f in self.futures:
            if f is not None:
                try:
                    f.result(timeout=max(0.0, horizon - time.perf_counter()))
                except Exception:  # a failed or late request counts at the horizon
                    pass

    def latencies_ms(self, t0: float, horizon: float):
        out, failed = [], 0
        for i, (due, *_rest) in enumerate(self.sched):
            f = self.futures[i]
            ok = f is not None and f.done() and f.exception() is None and self.done[i]
            if not ok:
                failed += 1
            end = self.done[i] if ok else horizon
            out.append((end - (t0 + due)) * 1e3)
        return out, failed


def _p95(v):
    return float(np.percentile(np.asarray(v, np.float64), 95, method="higher"))


def build(ctx_config, p, seed, dev):
    """The service over the configuration's model, warmed up, its pools and
    the decode streams coded at set-up."""
    from lic_tpu_torch.models.compress import set_numerics_flags
    from lic_tpu_torch.serving import CodecService

    set_numerics_flags()
    weights = system.make_weights(ctx_config, seed, dev)
    model = system.build_program(ctx_config, weights, dev)
    svc = CodecService(model, name=ctx_config["preset"], max_batch=int(p["max_batch"]),
                       max_wait_ms=float(p["max_wait_ms"]))
    pool = make_pool(p, seed, dev)
    with torch.no_grad():
        streams = [svc.coder.compress_batch(x) for x in pool]
    images = [list(x.permute(0, 2, 3, 1).contiguous().cpu().numpy()) for x in pool]
    svc.warmup([tuple(s) for s in p["sizes"]])
    return svc, model, weights, pool, images, streams


def run(ctx):
    p, dev, rec = ctx.traffic, ctx.device, ctx.record
    svc, model, weights, pool, images, streams = build(ctx.config, p, ctx.seed, dev)
    coder = svc.coder
    formed = []  # (kind, h, w, n, start) of each batch the service ran
    if ctx.trace:
        inner_c, inner_d = coder.compress_batch, coder.decompress_batch

        def compress_batch(xs, rates=None):
            if rec.recording:
                formed.append(("c", *xs.shape[2:], xs.shape[0], time.perf_counter()))
            with torch.profiler.record_function("compress_batch"):
                return inner_c(xs, rates=rates)

        def decompress_batch(blobs):
            h, w = coder._parse_header(blobs[0])[1:3]
            if rec.recording:
                formed.append(("d", h, w, len(blobs), time.perf_counter()))
            with torch.profiler.record_function("decompress_batch"):
                return inner_d(blobs)

        coder.compress_batch, coder.decompress_batch = compress_batch, decompress_batch
    sched = schedule(p, ctx.seed, ctx.seconds)
    loop = OpenLoop(svc, sched, images, streams)
    svc.start()
    try:
        torch.cuda.reset_peak_memory_stats()
        ctx.window_start()
        t0 = time.perf_counter()
        loop.run(t0)
        horizon = t0 + ctx.seconds + float(p["drain_s"])
        loop.wait(horizon)
        lat, failed = loop.latencies_ms(t0, horizon)
        lateness = max((s - (t0 + d[0])) * 1e3 for s, d in zip(loop.sent, sched))
        if ctx.trace:
            rec.recording = False
            extra = schedule(p, ctx.seed + 1, float(p["traced_s"]))
            ctx.profile(lambda: _traced(svc, extra, images, streams))
        memory = torch.cuda.max_memory_allocated()
        sample = _sample(sched, loop, int(p["checked"]), ctx.seed)
        decoded = {}
        with torch.no_grad():
            for i in sample:
                kind, s, k = sched[i][1:]
                out = loop.futures[i].result()
                if kind == "c":
                    try:
                        out = coder.decompress_batch([out])[0].permute(1, 2, 0).cpu().numpy()
                    except ValueError:  # the stream does not decode: a wrong answer
                        decoded[i] = None
                        continue
                decoded[i] = torch.from_numpy(np.ascontiguousarray(out)).permute(2, 0, 1)
    finally:
        svc.stop()
    if ctx.trace:
        _queue_waits(rec, formed, sched, loop, t0)
    ctx.extra.update(generator_lateness_ms=lateness,
                     served_per_s=(len(sched) - failed) / ctx.seconds)
    del svc, coder, model
    torch.cuda.empty_cache()
    found = judge(ctx.config, weights, pool, sched, decoded, dev)
    if len(decoded) != len(sample) or not sample:
        found = {k: float("inf") for k in found}
    ctx.extra.update({k: found[k] for k in compare.READINGS})
    checks = compare.checks(found, ctx.config["limits"])
    return {"attempted": len(sched), "failed": failed, "memory_peak_bytes": memory,
            "e2e": {"serve_p95_ms": _p95(lat)}, "checks": checks}


def judge(config, weights, pool, sched, decoded, device) -> dict:
    """The worst sampled decode's numbers against the reference's forward
    of its image in float64 (the reference runs each size's pool as one
    batch); infinity where a sampled request has no decode."""
    ref = system.build_reference(config, weights, device)
    want, readings = {}, []
    with torch.no_grad():
        for i, got in decoded.items():
            if got is None:
                readings = []
                break
            _, _, s, k = sched[i]
            if s not in want:
                want[s] = ref(pool[s].to(ref.dtype))["x_hat"].cpu()
            readings.append(compare.image_readings(got[None], want[s][k: k + 1]))
    del ref
    torch.cuda.empty_cache()
    system.fp32_numerics()
    return compare.worst(readings)


def _sample(sched, loop, n: int, seed: int):
    ok = [i for i, f in enumerate(loop.futures)
          if f is not None and f.done() and f.exception() is None]
    rng = np.random.default_rng(seed + 2)
    return sorted(rng.choice(ok, min(n, len(ok)), replace=False).tolist()) if ok else []


def _traced(svc, sched, images, streams) -> None:
    loop = OpenLoop(svc, sched, images, streams)
    t0 = time.perf_counter()
    loop.run(t0)
    loop.wait(t0 + 60.0)


def _queue_waits(rec, formed, sched, loop, t0) -> None:
    """Each request's wait from its due time to the start of the batch
    that took it: the service serves each (kind, size) bucket first in,
    first out, so a bucket's batches take its accepted requests in the
    order they were submitted."""
    order = defaultdict(list)
    for i, (due, kind, s, k) in enumerate(sched):
        if loop.futures[i] is not None:
            h, w = loop.images[s][k].shape[:2]
            order[(kind, h, w)].append(due)
    taken = defaultdict(int)
    waits = []
    for kind, h, w, n, start in formed:
        key = (kind, h, w)
        dues = order[key][taken[key]: taken[key] + n]
        taken[key] += n
        waits += [(start - (t0 + d)) * 1e3 for d in dues]
    rec.values.update(queue_waits_ms=waits, batch_sizes=[f[3] for f in formed])
