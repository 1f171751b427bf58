"""The port's ``CodecService`` on the CPU: the six cases of
``tests/test_serving.py``, held to the JAX package where there is a
counterpart, and the port's own guarantees.

``source_net`` and ``source_net_vr`` at ``n_override=32``, weights from
the JAX package's init, 64×64 and 128×64 images.

* batched equals direct: four requests in one batch; every stream equals
  ``coder.compress`` of that image alone and the JAX coder's stream, and
  every decode equals ``coder.decompress`` bit for bit (the JAX service
  pads partial batches and holds pixels within 1e-5; the port pads
  nothing, and its coder's passes do not depend on the batch);
* mixed rates share a batch, each stream its image alone at its rate;
* a rate on a model without gain units is refused;
* mixed sizes go to separate buckets;
* backpressure, and a stopped service refuses requests; ``stop(drain=False)``
  fails the queued futures;
* bad input is refused;
* the scheduler thread builds no autograd graph, though the caller's
  thread has grad mode on;
* a failed batch gives its exception to every one of its futures and
  counts its requests in ``errors``, and the service goes on serving;
* each request's queue wait is kept, and the coder's call nests under
  the batch's ``service.dispatch`` span.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.serving import CodecService, ServiceStats
from lic_tpu_torch.utils.params import params_from_flax
from lic_tpu_torch.utils.profiling import records, reset_spans

torch.set_num_threads(2)

N = 32
TIMEOUT = 300


def _pair(name):
    jm = JCodecModel(jget_config(name, n_override=N))
    init = jax.jit(lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 64, 64, 3)), training=True))
    params = jax.tree.map(np.array, init(jax.random.PRNGKey(0))["params"])
    tm = build_model(name, device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params, PRESETS[name]))
    return jm, params, tm


@pytest.fixture(scope="module")
def plain():
    return _pair("source_net")


@pytest.fixture(scope="module")
def vr():
    return _pair("source_net_vr")


def _imgs(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (h, w, 3)).astype(np.float32) for _ in range(n)]


def _nchw(img):
    return torch.from_numpy(img).permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)


def test_batched_roundtrip_matches_direct(plain):
    jm, params, tm = plain
    svc = CodecService(tm, max_batch=4, max_wait_ms=50).start()
    try:
        imgs = _imgs(4, 64, 64)
        futs = [svc.submit_compress(im) for im in imgs]
        blobs = [f.result(timeout=TIMEOUT) for f in futs]
        jc = JChannelCoder(jm, params)
        for im, blob in zip(imgs, blobs):
            assert blob == svc.coder.compress(_nchw(im))
            assert blob == jc.compress(jnp.asarray(im[None]))
        recs = [f.result(timeout=TIMEOUT) for f in [svc.submit_decompress(b) for b in blobs]]
        for rec, blob in zip(recs, blobs):
            assert rec.shape == (64, 64, 3) and rec.dtype == np.float32
            np.testing.assert_array_equal(rec, svc.coder.decompress(blob)[0].permute(1, 2, 0).numpy())
        s = svc.stats.snapshot()
        assert s["requests"] == 8 and s["errors"] == 0
        assert s["mean_batch"] > 1.0
    finally:
        svc.stop()


def test_per_request_rates_share_a_batch(vr):
    _, _, tm = vr
    svc = CodecService(tm, max_batch=3, max_wait_ms=50).start()
    try:
        img = _imgs(1, 64, 64, seed=3)[0]
        rates = [0.0, 3.0, None]
        futs = [svc.submit_compress(img, rate=r) for r in rates]
        lo, hi, default = (f.result(timeout=TIMEOUT) for f in futs)
        assert len(lo) < len(hi)
        assert default == lo  # None is the coder's rate, 0
        for blob, r in zip((lo, hi), rates):
            assert blob == svc.coder.compress(_nchw(img), rate=r)
            rec = svc.submit_decompress(blob).result(timeout=TIMEOUT)
            np.testing.assert_array_equal(
                rec, svc.coder.decompress(blob)[0].permute(1, 2, 0).numpy())
        s = svc.stats.snapshot()
        assert s["errors"] == 0 and s["batches"] == 3  # the 3 compresses in one
    finally:
        svc.stop()


def test_rate_on_gain_free_model_rejected(plain):
    svc = CodecService(plain[2])
    with pytest.raises(ValueError, match="gain units"):
        svc.submit_compress(_imgs(1, 64, 64)[0], rate=1.0)
    with pytest.raises(ValueError, match="gain units"):
        CodecService(plain[2], rate=1.0)


def test_mixed_sizes_bucket_separately(plain):
    svc = CodecService(plain[2], max_batch=4, max_wait_ms=5).start()
    try:
        a = svc.submit_compress(_imgs(1, 64, 64, seed=1)[0])
        b = svc.submit_compress(_imgs(1, 128, 64, seed=2)[0])
        blob_a, blob_b = a.result(timeout=TIMEOUT), b.result(timeout=TIMEOUT)
        ra = svc.submit_decompress(blob_a).result(timeout=TIMEOUT)
        rb = svc.submit_decompress(blob_b).result(timeout=TIMEOUT)
        assert ra.shape == (64, 64, 3) and rb.shape == (128, 64, 3)
        assert svc.stats.snapshot()["batches"] == 4
    finally:
        svc.stop()


def test_backpressure_and_stopped_errors(plain):
    svc = CodecService(plain[2], max_batch=2, max_queue=1)
    # not started: the queue fills and the second request is refused
    queued = svc.submit_compress(_imgs(1, 64, 64)[0])
    with pytest.raises(RuntimeError, match="queue full"):
        svc.submit_compress(_imgs(1, 64, 64)[0])
    svc.stop(drain=False)
    with pytest.raises(RuntimeError, match="stopped"):
        queued.result(timeout=1)
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit_compress(_imgs(1, 64, 64)[0])
    # started and stopped with draining: the queued request is served
    svc = CodecService(plain[2], max_batch=2, max_wait_ms=1000)
    fut = svc.submit_compress(_imgs(1, 64, 64)[0])
    svc.start()
    svc.stop()
    assert isinstance(fut.result(timeout=1), bytes)


def test_bad_input_rejected(plain):
    svc = CodecService(plain[2])
    with pytest.raises(ValueError, match="expected"):
        svc.submit_compress(np.zeros((64, 64), np.float32))
    with pytest.raises(ValueError, match="bad magic"):
        svc.submit_decompress(b"nope" * 8)


def test_scheduler_thread_builds_no_graph(plain):
    """The caller has grad mode on; every module call of the service's
    passes runs with it off, in the scheduler thread."""
    tm = plain[2]
    seen = []
    hook = tm.g_a.register_forward_hook(
        lambda mod, inp, out: seen.append((threading.current_thread().name,
                                           torch.is_grad_enabled(), out.requires_grad)))
    hook_s = tm.g_s.register_forward_hook(
        lambda mod, inp, out: seen.append((threading.current_thread().name,
                                           torch.is_grad_enabled(), out.requires_grad)))
    svc = CodecService(tm, max_batch=2, max_wait_ms=5).start()
    try:
        assert torch.is_grad_enabled()
        blob = svc.submit_compress(_imgs(1, 64, 64, seed=5)[0]).result(timeout=TIMEOUT)
        svc.submit_decompress(blob).result(timeout=TIMEOUT)
    finally:
        svc.stop()
        hook.remove()
        hook_s.remove()
    assert len(seen) == 2
    assert all(name == "codec-service" and not grad and not req for name, grad, req in seen)


def test_failed_batch_fails_every_future_and_counts(plain, monkeypatch):
    svc = CodecService(plain[2], max_batch=3, max_wait_ms=50)
    boom = RuntimeError("device lost")

    def fail(xs, rates=None):
        raise boom

    monkeypatch.setattr(svc.coder, "compress_batch", fail)
    futs = [svc.submit_compress(im) for im in _imgs(3, 64, 64, seed=6)]
    svc.start()
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=TIMEOUT)
        s = svc.stats.snapshot()
        assert s["errors"] == 3 and s["requests"] == 0
        monkeypatch.undo()
        # the scheduler survived: the next batch is served
        blob = svc.submit_compress(_imgs(1, 64, 64, seed=7)[0]).result(timeout=TIMEOUT)
        assert isinstance(blob, bytes)
        assert svc.stats.snapshot()["requests"] == 1
    finally:
        svc.stop()


def test_stats_snapshot_percentiles():
    st = ServiceStats()
    st.record(4, [10.0, 20.0, 30.0, 40.0], [1.0, 2.0, 3.0, 4.0])
    st.record(2, [50.0, 60.0], [5.0, 6.0])
    st.record_error(1)
    s = st.snapshot()
    assert s == {"requests": 6, "batches": 2, "errors": 1, "mean_batch": 3.0,
                 "p50_ms": 40.0, "p95_ms": 60.0, "queue_wait_p95_ms": 6.0}


def test_queue_waits_and_the_dispatch_span(plain):
    """Each request's wait from ``submit`` to dispatch is kept beside its
    latency, and the coder's call nests under the batch's
    ``service.dispatch`` span."""
    reset_spans()
    svc = CodecService(plain[2], max_batch=2, max_wait_ms=50).start()
    try:
        futs = [svc.submit_compress(im) for im in _imgs(2, 64, 64, seed=8)]
        for f in futs:
            f.result(timeout=TIMEOUT)
    finally:
        svc.stop()
    s = svc.stats.snapshot()
    assert len(svc.stats.queue_waits_ms) == 2
    assert 0.0 < s["queue_wait_p95_ms"] < s["p95_ms"]
    recs = records()
    (dispatch,) = [r for r in recs if r.name == "service.dispatch"]
    (root,) = [r for r in recs if r.name == "coder.compress"]
    assert root.parent == dispatch.id and root.call == dispatch.call
    assert dispatch.start_ns <= root.start_ns <= root.end_ns <= dispatch.end_ns
