"""The reference agrees with the program on the CPU, and the operation
and byte counters agree with hand counts."""

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
