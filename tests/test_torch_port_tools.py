"""The port's measurement scripts, on the CPU: the sub-pixel lowering of
the deconv probe equals ``F.conv_transpose2d`` (atol 1e-5: another
summation order), the profile's device busy time is the union of the
device intervals in a trace, the build's ``ptxas`` summary keeps each
kernel's register and spill counts, and the kernel probe still finds the
lines of the B1 and B2 sources it attaches to."""

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
