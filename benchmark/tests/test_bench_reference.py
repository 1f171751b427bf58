"""The reference agrees with the program on the CPU, the operation and
byte counters agree with hand counts, and the weights and counts each
configuration's reference class gives are pinned."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import roofline, run, system
from benchmark.images import smooth_images
from benchmark.reference import layers as L
from benchmark.tests.cpu import full_spec

SPEC = full_spec()
CONFIGS = [c["name"] for c in SPEC["configs"]]


def _config(name):
    cell = [w for w in SPEC["workloads"] if w["config"] == name][0]
    return run.config_of(SPEC, cell)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_program_on_the_cpu(name):
    from lic_tpu_torch.models.compress import ChannelCoder

    torch.manual_seed(0)
    config = _config(name)
    w = system.make_weights(config, 11, "cpu")
    prog = system.build_program(config, w, "cpu")
    ref = system.build_reference(config, w, "cpu", "float32")
    x = smooth_images(np.random.default_rng(1), 1, 128, 128, "cpu")
    with torch.no_grad():
        want = ref(x)["x_hat"]
        got = prog(x).x_tilde
        coder = ChannelCoder(prog, name=config["preset"])
        dec = coder.decompress_batch(coder.compress_batch(x))
    assert float((got - want).abs().max()) < 1e-4
    assert float((dec - want).abs().max()) < 1e-4


def test_weights_follow_the_seed_and_cover_every_leaf():
    config = _config(CONFIGS[0])
    a, b, c = (system.make_weights(config, s, "cpu") for s in (1, 1, 2))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["g_a.down0.weight"], c["g_a.down0.weight"])
    ref = system.reference_meta(config)
    assert set(a) == {n for n, _ in ref.named_parameters()}
    # GDN's stored values give β ≥ 1 and Γ ≥ 0
    rp = L.NonNegativeParametrizer(1e-6)
    assert float(rp(a["g_a.gdn0.beta"]).min()) >= 1.0 - 1e-6


def test_flop_and_byte_counts_match_hand_counts():
    conv = L.Conv2d(16, 32, 3, 1, 1)
    deconv = L.ConvTranspose2d(32, 8, 5, 2, 2, 1)
    with torch.device("meta"):
        conv, deconv = L.Conv2d(16, 32, 3, 1, 1), L.ConvTranspose2d(32, 8, 5, 2, 2, 1)
        x = torch.empty(2, 16, 10, 12)
        y = conv(x)
        # every output position: 16·3·3 multiply-adds per output channel
        assert roofline.count_flops(lambda: conv(x)) == 2 * (2 * 32 * 10 * 12) * 16 * 9
        # a transposed conv scatters each input position through the whole kernel
        assert roofline.count_flops(lambda: deconv(y)) == 2 * (2 * 32 * 10 * 12) * 8 * 25
        out = deconv(y)
    assert out.shape == (2, 8, 20, 24)
    assert roofline.nbytes(x, None, out) == 4 * (2 * 16 * 10 * 12 + 2 * 8 * 20 * 24)
    assert roofline.param_bytes([conv]) == 4 * (32 * 16 * 9 + 32)
    assert roofline.bound_s(165e12, 0) == pytest.approx(1.0, rel=1e-3)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)


# Computed with the harness of commit 9124aa6, before the model-specific
# declarations moved into the reference classes: the weights at seed 12345
# (sha256 over each leaf's name and bytes, in draw order) and the counts of
# 8 images of 512 x 768 on the meta device.  Both must stay as they were.
PINNED = {
    "source_net": {
        "weights": "a3fe42273d3fb579f877312ebae0c7050c7953758c670cc8f6e24954383631fd",
        "roundtrip_flops": 1851895427072, "analyze_bytes": 58750464,
        "synthesize_bytes": 59191104,
        "flops": {"analyze": 574384766976, "hyper_encode": 15231614976,
                  "hyper_decode": 30463229952, "syntax": 56651776,
                  "slice_chain": 258880831488, "synthesize": 683534270464},
    },
    "net_unet_ha_hs_dec": {
        "weights": "d99b3a35631e43f2459f23a1e7e1f12ccc1b590d4b90721a34b4696099571dc5",
        "roundtrip_flops": 8601705951232, "analyze_bytes": 114951920,
        "synthesize_bytes": 113242688,
        "flops": {"analyze": 4121841106944, "hyper_encode": 23737663488,
                  "hyper_decode": 34838937600, "syntax": 1273982976,
                  "slice_chain": 421955371008, "synthesize": 3541264580608},
    },
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_and_counts_are_the_pinned_ones(name):
    config = _config(name)
    digest = hashlib.sha256()
    for k, v in system.make_weights(config, 12345, "cpu").items():
        digest.update(k.encode())
        digest.update(v.contiguous().numpy().tobytes())
    counts = system.reference_meta(config).counts(8, 512, 768)
    want = dict(PINNED[name])
    assert digest.hexdigest() == want.pop("weights")
    assert counts == want


@pytest.mark.parametrize("preset, overrides, model", [
    ("source_net_vr", {}, {}),  # gain units
    ("source_net", {"post_processing": True}, {}),  # the HAN tail
    ("source_net", {"lrp": False}, {"lrp": False}),  # the file says so too
    ("source_net", {}, {"num_slices": 5}),  # the file and the program differ
    ("source_net", {}, {"context_rows": 3}),  # a key the program has no field for
])
def test_the_program_is_refused_where_the_reference_does_not_model_it(
        monkeypatch, preset, overrides, model):
    import lic_tpu_torch.models as models

    build = models.build_model
    monkeypatch.setattr(models, "build_model", lambda name, **k: build(name, **k, **overrides))
    config = _config("source_net")
    config = dict(config, preset=preset, model=dict(config["model"], **model))
    with pytest.raises(ValueError, match="differs from the file"):
        system.build_program(config, system.make_weights(_config("source_net"), 1, "cpu"), "cpu")
