"""The port's measurement scripts, on the CPU: the sub-pixel lowering of
the deconv probe equals ``F.conv_transpose2d`` (atol 1e-5: another
summation order), the profile's device busy time is the union of the
device intervals in a trace, the build's ``ptxas`` summary keeps each
kernel's register and spill counts, the kernel probe still finds the
lines of the B1 and B2 sources it attaches to, and the batch probe's
card-vs-CPU rows count nothing between two equal models and the rows a
perturbed σ path moves."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lic_tpu_torch.tools.deconv_probe import subpel_conv_transpose2d, subpel_weights
from lic_tpu_torch.tools.kernel_probe import (
    DRAIN_STEPS,
    gdn_variant_source,
    instrumented_drain_source,
)
from lic_tpu_torch.tools.profile_path import device_activity, union_length
from lic_tpu_torch.utils.build import CudaLibrary

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "cin,cout,h,w,padding",
    [(8, 8, 17, 25, 3), (6, 4, 9, 13, 3), (8, 8, 8, 12, 2)],
)
def test_subpel_lowering_equals_conv_transpose2d(cin, cout, h, w, padding):
    g = torch.Generator().manual_seed(cin * h + padding)
    x = torch.randn(2, cin, h, w, generator=g)
    wt = torch.randn(cin, cout, 5, 5, generator=g) * 0.1
    b = torch.randn(cout, generator=g)
    ref = F.conv_transpose2d(x, wt, b, 2, padding, 1)
    wc, dmin, T = subpel_weights(wt, 2, padding)
    assert wc.shape == (cout * 4, cin, T, T)
    y = subpel_conv_transpose2d(x, wc, b, dmin, T, 2, ref.shape[2:])
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)


def test_union_length_merges_overlaps():
    assert union_length([]) == 0.0
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def test_device_activity_reads_device_events_only():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 2.0, "dur": 4.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 10.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 50.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1.0},
    ]
    act = device_activity(events)
    assert act["busy_us"] == 8.0
    assert act["span_us"] == 12.0
    assert act["kernels"] == [("k1", [8.0, 2])]
    with pytest.raises(RuntimeError, match="no device activity"):
        device_activity(events[3:])


def test_ptxas_summary_keeps_registers_and_spills():
    lib = CudaLibrary("conv_direct.cu", lambda so: None)
    lib.log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 233 registers, used 1 barriers, 26624 bytes smem
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
"""
    assert lib.ptxas() == [
        "_Z6kernelPf: Used 233 registers, used 1 barriers, 26624 bytes smem"
        " | 8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "_Z5otherv: Used 40 registers | 0 bytes stack frame, 0 bytes spill stores,"
        " 0 bytes spill loads",
    ]


def test_kernel_probe_attaches_to_the_kernel_sources():
    """Every probe point of B1's chunk lands once, and B2's variant
    differs from the kernel's source."""
    src = instrumented_drain_source()
    for k in range(len(DRAIN_STEPS)):
        assert src.count(f"PT({k});") == 1
    assert gdn_variant_source("no_mma") != gdn_variant_source("kernel")
    with pytest.raises(ValueError, match="no gdn variant"):
        gdn_variant_source("other")


@pytest.mark.parametrize("preset", ["source_net", "entroformer_cb", "neural_syntax"])
def test_rows_card_vs_cpu_counts_the_decoders_rows(preset):
    """``batch_probe.rows_card_vs_cpu`` with both sides on the CPU: no row
    differs; with the 'CPU' side's σ path perturbed, the rows it counts
    are those the perturbation moves, from the first step on."""
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.tools.batch_probe import rows_card_vs_cpu, wake_eb

    torch.set_num_threads(2)
    a = build_model(preset, device="cpu", n_override=32)
    b = build_model(preset, device="cpu", n_override=32)
    if not a.is_ns:
        assert wake_eb(a) == wake_eb(b) > 0
    x = torch.from_numpy(smooth_images(np.random.default_rng(0), 2, 64, 128))
    same = rows_card_vs_cpu(a, b, ChannelCoder(a), ChannelCoder(b), x)
    assert same["rows"] == 0 and same["first_step"] is None
    assert same["symbols"] == 2 * 4 * 8 * (32 - (16 if a.is_ns else 0))
    assert len(same["steps"]) == {"source_net": 4, "entroformer_cb": 2,
                                  "neural_syntax": 2 * 3 + 8}[preset]
    cb = ChannelCoder(b)
    with torch.no_grad():  # σ at init sits on one row; move it
        if preset == "source_net":
            b.cc_scale_transforms[1].c2.bias.add_(1.0)
        elif preset == "entroformer_cb":
            cb.tab.mul_(2.0)
        else:
            for p in b.prediction_model.parameters():
                p.mul_(1.5)
    moved = rows_card_vs_cpu(a, b, ChannelCoder(a), cb, x)
    assert moved["rows"] == sum(moved["steps"]) > 0
    if preset == "source_net":  # slice 1's σ head: slice 0's rows stay
        assert moved["first_step"] == 1 and moved["steps"][0] == 0


def test_cpu_decode_outcomes_counts_equal_and_raised():
    """``batch_probe.cpu_decode_outcomes`` with both coders on the CPU:
    every stream decodes equal; with the decoder's scale table moved, the
    decodes raise at the final-state check (none returns other pixels)."""
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.tools.batch_probe import cpu_decode_outcomes

    torch.set_num_threads(2)
    m = build_model("source_net", device="cpu", n_override=32)
    x = torch.from_numpy(smooth_images(np.random.default_rng(1), 2, 64, 64))
    assert cpu_decode_outcomes(ChannelCoder(m), ChannelCoder(m), x) == {
        "equal": 2, "raised": 0, "other": 0}
    cb = ChannelCoder(m)
    cb.tab.mul_(0.5)
    assert cpu_decode_outcomes(ChannelCoder(m), cb, x) == {"equal": 0, "raised": 2, "other": 0}
