"""Serving: request batching over the codec (counterpart of
``lic_tpu/serving/service.py:52-312``).

Requests are admitted on any thread, queued in one FIFO per (kind, image
size), and one scheduler thread drives the model: a bucket is dispatched
as one ``ChannelCoder.compress_batch`` / ``decompress_batch`` when it
holds ``max_batch`` requests or when its oldest request has waited
``max_wait_ms``.

Usage::

    svc = CodecService(build_model("source_net_vr"), name="source_net_vr",
                       max_batch=8).start()
    fut = svc.submit_compress(img, rate=1.5)   # (H, W, 3) float in [−1, 1]
    blob = fut.result()
    rec = svc.submit_decompress(blob).result()  # (H, W, 3) float32
    svc.stop()

Guarantees:

* requests of different sizes never share a batch;
* requests at different rates do: each image's gains broadcast on the
  device, and each stream carries its own rate;
* every stream equals ``coder.compress`` of that image alone at its rate,
  and every reconstruction equals ``coder.decompress`` of that stream:
  the coder runs its model passes on a fixed number of images whatever
  the batch (``models.compress`` §C5), so a partial batch is not padded
  to ``max_batch`` as the JAX service pads it to avoid a recompile;
* ``max_wait_ms`` bounds the latency batching adds under low load, a full
  bucket is dispatched at once, and ``max_queue`` queued requests refuse
  the next one (backpressure);
* a batch that fails gives its exception to every one of its futures and
  counts its requests in ``ServiceStats.errors``; ``stop(drain=False)``
  fails the queued futures instead of leaving them unresolved.

torch's grad mode belongs to each thread, so the scheduler thread runs
its passes under ``torch.no_grad()`` itself.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    latencies_ms: Deque[float] = field(default_factory=lambda: deque(maxlen=4096))
    # the scheduler appends while a monitoring thread may snapshot
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, n: int, latencies: List[float]) -> None:
        with self._lock:
            self.requests += n
            self.batches += 1
            self.latencies_ms.extend(latencies)

    def record_error(self, n: int) -> None:
        with self._lock:
            self.errors += n

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self.latencies_ms)
            requests, batches, errors = self.requests, self.batches, self.errors
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0
        return {
            "requests": requests,
            "batches": batches,
            "errors": errors,
            "mean_batch": requests / batches if batches else 0.0,
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
        }


class _Req:
    __slots__ = ("kind", "payload", "future", "t0")

    def __init__(self, kind: str, payload: Any):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()
        self.t0 = time.perf_counter()


class CodecService:
    """Dynamic-batching codec server over one model, on the model's
    device."""

    def __init__(
        self,
        model,
        name: str = "",
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        rate: Optional[float] = None,
    ):
        from ..models.compress import ChannelCoder

        # ``rate`` is the default operating point; requests may name others
        self.coder = ChannelCoder(model, name=name, rate=rate)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.stats = ServiceStats()
        self._lock = threading.Condition()
        self._queues: Dict[Tuple, Deque[_Req]] = defaultdict(deque)
        self._pending = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ admit

    def submit_compress(self, image: np.ndarray, rate: Optional[float] = None) -> Future:
        """image: (H, W, 3) float32 in [−1, 1] → Future[bytes].  ``rate``:
        this request's gain-unit rate index (variable-rate models; e.g.
        from ``solve_rate_for_bpp``)."""
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
        if rate is not None and not self.coder.has_gain:
            raise ValueError("rate= was given but this model has no gain units")
        return self._enqueue(
            ("c", img.shape[0], img.shape[1]),
            _Req("c", (img, None if rate is None else float(rate))),
        )

    def submit_decompress(self, blob: bytes) -> Future:
        """blob: one bitstream of this codec → Future[np.ndarray (H, W, 3)]."""
        _, h, w, _ = self.coder._parse_header(blob)
        return self._enqueue(("d", h, w), _Req("d", blob))

    def _enqueue(self, bucket: Tuple, req: _Req) -> Future:
        with self._lock:
            if self._stopping:
                raise RuntimeError("CodecService is stopped")
            if self._pending >= self.max_queue:
                raise RuntimeError(
                    f"CodecService queue full ({self.max_queue}) — backpressure"
                )
            self._queues[bucket].append(req)
            self._pending += 1
            self._lock.notify()
        return req.future

    # -------------------------------------------------------- scheduler

    def start(self) -> "CodecService":
        with self._lock:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="codec-service", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the service; new admissions are refused at once.
        ``drain=True`` serves everything already queued first;
        ``drain=False`` fails the queued requests with RuntimeError."""
        with self._lock:
            self._stopping = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        r = q.popleft()
                        self._pending -= 1
                        if r.future.set_running_or_notify_cancel():
                            r.future.set_exception(RuntimeError("CodecService stopped"))
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def warmup(self, sizes: List[Tuple[int, int]], batch: Optional[int] = None) -> None:
        """One compress and decompress of ``batch`` (default
        ``max_batch``) blank images per (H, W): cuDNN's choice of
        algorithms and B3/B6's weight split happen here, not on a live
        request."""
        b = batch or self.max_batch
        for h, w in sizes:
            blobs = self.coder.compress_batch(self._images(np.zeros((b, h, w, 3), np.float32)))
            self.coder.decompress_batch(blobs)

    def _images(self, x: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) numpy → (B, 3, H, W) on the coder's device, in
        ``channels_last``."""
        return torch.from_numpy(x).permute(0, 3, 1, 2).to(
            self.coder.device, memory_format=torch.channels_last)

    def _take_batch(self) -> Optional[List[_Req]]:
        """With the lock held: the requests of a full or timed-out bucket
        (when stopping, of any non-empty one), oldest first."""
        now = time.perf_counter()
        best = None
        for bucket, q in self._queues.items():
            if not q:
                continue
            full = len(q) >= self.max_batch
            aged = (now - q[0].t0) * 1000.0 >= self.max_wait_ms
            if full or aged or self._stopping:
                if best is None or q[0].t0 < self._queues[best][0].t0:
                    best = bucket
        if best is None:
            return None
        q = self._queues[best]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        self._pending -= len(batch)
        return batch

    def _next_deadline_s(self) -> float:
        """With the lock held: seconds until the oldest queued request
        times out."""
        now = time.perf_counter()
        wait = self.max_wait_ms / 1000.0
        for q in self._queues.values():
            if q:
                wait = min(wait, self.max_wait_ms / 1000.0 - (now - q[0].t0))
        return max(wait, 1e-4)

    def _run(self) -> None:
        with torch.no_grad():
            while True:
                with self._lock:
                    batch = self._take_batch()
                    if batch is None:
                        if self._stopping and self._pending == 0:
                            return
                        self._lock.wait(timeout=self._next_deadline_s())
                        continue
                self._process(batch)

    def _process(self, batch: List[_Req]) -> None:
        # a future that is running can no longer be cancelled by its caller
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        n = len(batch)
        if not n:
            return
        try:
            if batch[0].kind == "c":
                xs = self._images(np.stack([r.payload[0] for r in batch]))
                rates = [r.payload[1] for r in batch]
                if any(rr is not None for rr in rates):
                    # None is the coder's default operating point
                    rates = [self.coder.rate if rr is None else rr for rr in rates]
                    results = self.coder.compress_batch(xs, rates=rates)
                else:
                    results = self.coder.compress_batch(xs)
            else:
                rec = self.coder.decompress_batch([r.payload for r in batch])
                results = list(rec.permute(0, 2, 3, 1).float().cpu().numpy())
        except Exception as e:  # the scheduler keeps serving; the callers get it
            self.stats.record_error(n)
            for r in batch:
                r.future.set_exception(e)
            return
        for r, value in zip(batch, results):
            r.future.set_result(value)
        t1 = time.perf_counter()
        self.stats.record(n, [(t1 - r.t0) * 1000.0 for r in batch])
