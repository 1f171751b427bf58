"""The benchmark's neural-syntax configuration on the CPU: its plain
reference (``benchmark/reference/neural_syntax.py``) against the port,
the context check ``compared`` adds to ``correct``, the coder's wavefront
spans and samples, the four wavefront readers and the operation counts.

The port's ``neural_syntax`` at ``n_override=32`` (N = 32, M = 16) on
2 seeded 128×192 images (an 8×12 latent, T = 26 wavefronts), with the
benchmark's weights from a fixed seed.
"""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lic_tpu_torch.models as models
from benchmark import run, system
from benchmark.images import smooth_images
from benchmark.reference import neural_syntax as NS
from benchmark.spans import Recorder
from lic_tpu_torch.models.compress import ChannelCoder, wavefront_groups
from lic_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, B, H, W = 32, 16, 2, 128, 192
HY, WY = H // 16, W // 16
T = 2 * (HY - 1) + WY
FULL = run.config_of(run.spec_of(), run.cell_of(run.spec_of(), "neural_syntax-code-b8"))
CONFIG = dict(FULL, model=dict(FULL["model"], N=N))
READERS = ("wavefront_decode_ms.batch", "wavefront_step_us.batch",
           "wavefront_drain_us.batch", "wavefront_mfu.batch")


@pytest.fixture(scope="module")
def built():
    """(program, float64 reference, weights, images): the program built
    through ``system.build_program`` at N = 32."""
    build = models.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, "build_model", lambda name, **k: build(name, **k, n_override=N))
        weights = system.make_weights(CONFIG, 19, "cpu")
        prog = system.build_program(CONFIG, weights, "cpu")
    ref = system.build_reference(CONFIG, weights, "cpu")
    x = smooth_images(np.random.default_rng(5), B, H, W, "cpu")
    return prog, ref, weights, x


@pytest.fixture(scope="module")
def roundtrip(built):
    prog, ref, _, x = built
    coder = ChannelCoder(prog, name="neural_syntax")
    with torch.no_grad():
        blobs = coder.compress_batch(x)
        decoded = coder.decompress_batch(blobs)
    return coder, blobs, decoded


def _reader(name):
    return run.load_module(os.path.join(run.BENCH_DIR, "layer_metrics", f"{name}.py"),
                           f"benchmark.layer_metrics.{name}")


def test_the_ports_eval_forward_equals_the_reference_in_float64(built):
    prog, ref, _, x = built
    model = copy.deepcopy(prog).double()
    with torch.no_grad():
        got, want = model(x.double()), ref(x.double())
        h2 = model.ns_hyper_decode(torch.round(model.ns_hyper_encode(model.analyze(x.double()))))
        mu_s, sigma_s = model.ns_syntax_params(h2)
    pairs = [(got.x_tilde, want["x_hat"]), (got.extras["content_mu"], want["context_mu"]),
             (got.extras["content_sigma"], want["context_sigma"]),
             (mu_s, want["syntax_mu"]), (sigma_s, want["syntax_sigma"])]
    for a, b in pairs:
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max()))
    assert float(got.bpp) == pytest.approx(float(want["bpp"]), rel=1e-12)
    assert float(want["context_sigma"].min()) > 0.11  # off the table's floor


def test_a_roundtrip_decodes_the_reference_and_its_context_is_the_references(built, roundtrip):
    prog, ref, _, x = built
    coder, _, decoded = roundtrip
    with torch.no_grad():
        want = ref(x.double())["x_hat"]
    assert float((decoded.double() - want).abs().max()) < 1e-5
    found = ref.compared(coder, x, decoded)
    assert set(found) == set(NS.NeuralSyntaxReference.COMPARED) | {"context_row_share"}
    for k in NS.NeuralSyntaxReference.COMPARED:
        assert 0 <= found[k] <= FULL["limits"][k], (k, found[k])
    assert found["context_row_share"] < 1e-3


def test_a_coder_with_mu_and_sigma_swapped_roundtrips_and_fails_compared(built, roundtrip):
    """ŷ = round(y) does not depend on the context, so a coder whose head
    gives (σ, μ) codes and decodes the same image; only ``compared``
    sees it."""
    prog, ref, _, x = built
    _, blobs, decoded = roundtrip
    coder = ChannelCoder(prog, name="neural_syntax")
    inner = prog.ns_context_head

    def swapped(merged):
        mu, sigma = inner(merged)
        return sigma, mu

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prog, "ns_context_head", swapped)
        with torch.no_grad():
            bad_blobs = coder.compress_batch(x)
            bad = coder.decompress_batch(bad_blobs)
        found = ref.compared(coder, x, bad)
    assert bad_blobs != blobs
    assert torch.equal(bad, decoded)
    failed = [k for k in NS.NeuralSyntaxReference.COMPARED if found[k] > FULL["limits"][k]]
    assert failed == list(NS.NeuralSyntaxReference.COMPARED), found


def test_compared_takes_the_control_as_its_side(built):
    _, ref, weights, x = built
    control = system.build_reference(CONFIG, weights, "cpu", "float32")
    found = ref.compared(control, x, None)
    system.fp32_numerics()
    for k in NS.NeuralSyntaxReference.COMPARED:
        assert 0 < found[k] < 1e-4, (k, found[k])


def test_the_wavefront_loop_records_its_spans_and_samples(built):
    prog, _, _, x = built
    coder = ChannelCoder(prog, name="neural_syntax")
    profiling.reset_spans()
    with torch.no_grad():
        coder.decompress_batch(coder.compress_batch(x))
    stats = profiling.span_stats()
    assert stats["coder.decompress.wavefront"]["count"] == 1
    assert stats["coder.compress.wavefront"]["count"] == 1
    assert stats["coder.wavefront.drain"]["count"] == T
    assert stats["coder.wavefront.head"]["count"] == 2 * T
    assert profiling.samples("coder.wavefront.steps") == [T, T]
    p_max = max(len(ps) for ps, _ in wavefront_groups(HY, WY))
    assert profiling.samples("coder.wavefront.slot_use") == [HY * WY / (p_max * T)] * 2
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    parent = lambda r: by_id[r.parent].name
    for r in recs:
        if r.name == "coder.wavefront.drain":
            assert parent(r) == "coder.decompress.wavefront"
        elif r.name == "coder.decompress.wavefront":
            assert parent(r) == "coder.decompress.launch"
        elif r.name == "coder.compress.wavefront":
            assert parent(r) == "coder.compress.launch"
        elif r.name == "coder.wavefront.head":
            assert parent(r) in ("coder.compress.wavefront", "coder.decompress.wavefront")
    # 32 x 48, the cell's latent: 1536 positions in 24 x 110 slots
    groups = wavefront_groups(32, 48)
    assert len(groups) == 110 and max(len(ps) for ps, _ in groups) == 24


@pytest.mark.parametrize("name, want", [
    ("wavefront_decode_ms.batch", 1e3 * 0.22),
    ("wavefront_step_us.batch", 1e6 * 0.22 / 110),
    ("wavefront_drain_us.batch", 1e6 * 0.0015),
    ("wavefront_mfu.batch", 100.0 * 3.3e11 / (0.22 * 495e12 / 3)),
])
def test_a_wavefront_reader_reads_the_programs_spans(monkeypatch, name, want):
    stats = {"coder.decompress.wavefront": {"count": 3, "median_s": 0.22},
             "coder.wavefront.drain": {"count": 330, "median_s": 0.0015}}
    monkeypatch.setattr(profiling, "span_stats", lambda: stats)
    monkeypatch.setattr(profiling, "samples",
                        lambda n: [110.0, 110.0, 110.0] if n == "coder.wavefront.steps" else [])
    rec = Recorder(True)
    rec.values.update(passes=3, context_flops=3.3e11)
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_wavefront_reader_gives_nothing_without_its_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "span_stats", lambda: {})
    monkeypatch.setattr(profiling, "samples", lambda n: [])
    rec = Recorder(True)
    rec.values.update(passes=3, context_flops=3.3e11)
    assert _reader(name).read(rec) is None
    assert _reader(name).read(Recorder(True)) is None  # an untraced run


def test_counts_of_the_cell_match_the_hand_count():
    counts = system.reference_meta(FULL).counts(8, 512, 768)
    n, m = 192, 16
    per_position = (2 * 16 * n * (2 * n - m) * 9 + 2 * (2 * 4 * n * n * 9)
                    + 2 * 4 * n * 2 * (n - m))
    assert per_position == 26_198_016
    assert counts["context_flops"] == counts["flops"]["context"] == 8 * 32 * 48 * per_position
    f = counts["flops"]
    assert counts["roundtrip_flops"] == (f["analyze"] + f["hyper_encode"] + f["syntax"]
                                         + 2 * (f["hyper_decode"] + f["syntax_params"]
                                                + f["context"]) + f["synthesize"])
    assert min(f.values()) > 0 and counts["analyze_bytes"] > 0 < counts["synthesize_bytes"]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    path = os.path.join(ROOT, "benchmark", "reference", "neural_syntax.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert not {n for n in names if n.split(".")[0] in ("lic_tpu_torch", "lic_tpu", "jax")}
    out = subprocess.run([sys.executable, "-c", "import benchmark.reference.neural_syntax, sys; "
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, check=True, capture_output=True, text=True,
                         env=dict(os.environ, USE_FLAX="0"))
    tops = set(ast.literal_eval(out.stdout.splitlines()[-1]))
    assert not tops & {"lic_tpu_torch", "lic_tpu", "jax", "jaxlib", "flax"}
