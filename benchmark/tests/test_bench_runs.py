"""Whole runs on the CPU at a small size, past the look for a chip: sound
runs come out correct, and runs whose timed path is broken underneath come
out not correct, one test for each fault the cell can have."""

import numpy as np
import pytest
import torch

from benchmark import run, system
from benchmark.tests.cpu import full_spec, patched_cuda, run_small

SPEC = full_spec()
CELLS = {c["name"]: run.traffic_of(c)["driver"] for c in SPEC["workloads"]}
SMALL = {
    "code_batch": {"driver": "code_batch", "batch": 2, "size": [128, 192], "pool": 2,
                   "checked": 1, "traced": 1},
    "serve_open": {"driver": "serve_open", "rate_per_s": 4.0, "max_batch": 4,
                   "max_wait_ms": 5, "sizes": [[128, 192], [192, 128]], "size_weights": [3, 1],
                   "decompress_share": 0.5, "pool": 2, "checked": 4, "drain_s": 60,
                   "traced_s": 0.5},
    "train": {"driver": "train", "batch": 2, "crop": 128, "lmbda": 0.0025, "images": 3,
              "image_size": [144, 208], "threads": 2, "checked": 3, "traced": 1},
}


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    """On the CPU the program runs the kernels' plain versions in fp32, the
    reference's own operations: judged against the fp32 reference, a sound
    run matches it to rounding, where against float64 a tiny image's few
    rounding flips move a large share of it."""
    torch.set_num_threads(4)
    monkeypatch.setattr(system, "JUDGE_PRECISION", "float32")
    with patched_cuda(monkeypatch):
        yield


def _run(cell, trace=0, seconds=0.5):
    return run_small(cell, 7, SMALL[CELLS[cell]], trace=trace, seconds=seconds)


def _one(driver):
    return [c for c, d in CELLS.items() if d == driver][0]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell, seconds=2.0 if CELLS[cell] == "serve_open" else 0.5)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in run.metrics_of(SPEC, run.cell_of(SPEC, cell), False)}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-2:] == ["checks", "_checks"]


@pytest.mark.parametrize("driver", ["code_batch", "train", "serve_open"])
def test_a_traced_run_reports_its_layer_metrics(driver):
    cell = _one(driver)
    out = _run(cell, trace=1, seconds=2.0 if driver == "serve_open" else 0.5)
    assert out["correct"]
    want = {m["name"] for m in run.metrics_of(SPEC, run.cell_of(SPEC, cell), True)}
    # the device's idle share needs a card's trace; everything else is read here
    assert set(out["metrics"]) == {m for m in want if not m.startswith("device_idle")}
    assert all(np.isfinite(v["value"]) and v["value"] >= 0 for v in out["metrics"].values())


def test_a_coder_without_a_z_coder_is_run(monkeypatch):
    """The coder of a model whose hyper stream has no ``z_coder`` (the
    neural-syntax coder has none): a traced run is correct, reads every
    metric, and records the host coding but no z decodes."""
    import lic_tpu_torch.models.compress as compress
    from benchmark.spans import Recorder

    real = compress.ChannelCoder

    class WithoutZ:
        """The program's coder with its ``z_coder`` hidden; its own calls
        of ``_pool_map`` go through this object's, as the harness wraps it."""

        _pool_map = staticmethod(real._pool_map)

        def __init__(self, model, name=""):
            self._inner = real(model, name=name)
            self._inner._pool_map = lambda fn, n, parent: self._pool_map(fn, n, parent)

        def __getattr__(self, k):
            if k == "z_coder":
                raise AttributeError(k)
            return getattr(self._inner, k)

    recorders = []
    collect = Recorder.collect
    monkeypatch.setattr(Recorder, "collect", lambda self: (recorders.append(self),
                                                             collect(self))[1])
    monkeypatch.setattr(compress, "ChannelCoder", WithoutZ)
    cell = _one("code_batch")
    out = _run(cell, trace=1)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in run.metrics_of(SPEC, run.cell_of(SPEC, cell), True)}
    assert set(out["metrics"]) == {m for m in want if not m.startswith("device_idle")}
    spans = recorders[0].host_s
    assert spans["host_coding"] and "z_decode" not in spans


def test_an_altered_decode_is_not_correct(monkeypatch):
    from lic_tpu_torch.models.compress import ChannelCoder

    inner = ChannelCoder.decompress_batch

    def altered(self, blobs):
        out = inner(self, blobs).clone()
        out[-1] += 0.05
        return out

    monkeypatch.setattr(ChannelCoder, "decompress_batch", altered)
    assert not _run(_one("code_batch"))["correct"]


def test_more_than_half_of_an_image_altered_is_not_correct(monkeypatch):
    """A decode whose last image is wrong over its upper five eighths only,
    so the cleanest twentieth of every image stays at its floor."""
    from lic_tpu_torch.models.compress import ChannelCoder

    inner = ChannelCoder.decompress_batch

    def altered(self, blobs):
        out = inner(self, blobs).clone()
        out[-1, :, : out.shape[2] * 5 // 8] += 0.05
        return out

    monkeypatch.setattr(ChannelCoder, "decompress_batch", altered)
    out = _run(_one("code_batch"))
    assert not out["correct"] and out["checks"]["decode_p5_err"]["value"] < 1e-6


def test_an_altered_stream_is_not_correct(monkeypatch):
    """A served compress request's stream with one byte of its payload
    changed where it is produced."""
    from lic_tpu_torch.models.compress import ChannelCoder

    inner, start = ChannelCoder.compress_batch, run.Context.window_start
    window = []

    def altered(self, xs, rates=None):
        out = inner(self, xs, rates)
        if not window:  # set-up's streams and warm-up stay sound
            return out
        b = bytearray(out[0])
        b[-3] ^= 0x5A
        return [bytes(b)] + out[1:]

    def opened(self):
        window.append(True)
        start(self)

    monkeypatch.setattr(ChannelCoder, "compress_batch", altered)
    monkeypatch.setattr(run.Context, "window_start", opened)
    assert not _run(_one("serve_open"), seconds=2.0)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from lic_tpu_torch.training.train import CodecOptimizer

    monkeypatch.setattr(CodecOptimizer, "step_if_finite", lambda self: True)
    out = _run(_one("train"))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] >= 0.99


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    import lic_tpu_torch.training as training

    make = training.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)
        return lambda state, batch, on_phase=None: step(state, batch[: len(batch) // 2],
                                                        on_phase)

    monkeypatch.setattr(training, "make_train_step", halved)
    assert not _run(_one("train"))["correct"]
