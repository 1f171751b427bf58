"""The port's two hand-written kernels against their plain versions, on
the card.  Every test here is marked ``cuda`` and skips without CUDA.

The file imports no jax, so it also runs on a GPU host without the JAX
package (``tests/conftest.py`` imports jax; pass ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from lic_tpu.coding.codec import GaussianCoder
from lic_tpu_torch.coding import (
    DeviceRans16Interleaved,
    drain_plain,
    random_streams,
    rans_drain,
)
from lic_tpu_torch.layers import gdn_fused, gdn_plain

pytestmark = pytest.mark.cuda

L = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA/Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("c,rows", [(16, 3000), (192, 5000)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_kernel_matches_plain(cuda_device, c, rows, inverse, dtype):
    """fp32: atol/rtol 1e-5 (sums in another order).  bf16: the output's
    own rounding, atol/rtol 1e-2."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(rows, c, generator=g)
    gamma = 0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)
    beta = 1.0 + torch.rand(c, generator=g)
    x = x.to(cuda_device, dtype)
    gamma, beta = gamma.to(cuda_device, dtype), beta.to(cuda_device)
    before = gdn_fused.launches
    y = gdn_fused(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert gdn_fused.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(
        y.float(), gdn_plain(x, gamma, beta, inverse).float(), atol=tol, rtol=tol
    )


def test_gdn_kernel_backward_raises(cuda_device):
    x = torch.randn(64, 16, device=cuda_device, requires_grad=True)
    y = gdn_fused(x, torch.eye(16, device=cuda_device), torch.ones(16, device=cuda_device), False)
    with pytest.raises(NotImplementedError):
        y.sum().backward()


def _streams(b, steps, seed):
    coder = GaussianCoder()
    cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
    cases = [(seed + i, True) for i in range(b)]
    return (cdfs, offsets), *random_streams(cdfs, offsets, cases, steps, L)


def test_drain_kernel_bitexact_vs_plain(cuda_device):
    steps = [1000, 333, 1]
    (cdfs, offsets), sym, idx, pay, ends = _streams(3, steps, seed=80)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    payt = torch.from_numpy(pay).to(cuda_device)
    k_lanes = p_lanes = dev.init_lanes(payt)
    off = 0
    for m in steps:
        rows = torch.from_numpy(idx[:, off : off + m]).to(cuda_device)
        before = rans_drain.launches
        k_lanes, k_dec = rans_drain(dev, k_lanes, payt, rows, m)
        torch.cuda.synchronize()
        assert rans_drain.launches == before + 1
        p_lanes, p_dec = drain_plain(dev, p_lanes, payt, rows, m)
        assert torch.equal(k_dec, p_dec)
        assert torch.equal(k_lanes.state, p_lanes.state)
        assert torch.equal(k_lanes.ptr, p_lanes.ptr)
        np.testing.assert_array_equal(k_dec.cpu().numpy(), sym[:, off : off + m])
        off += m
    assert bool((k_lanes.state == 1 << 16).all())
    assert k_lanes.ptr.tolist() == ends


def test_drain_kernel_rejects_payload_without_trailing_zeros(cuda_device):
    (cdfs, offsets), _, idx, pay, _ = _streams(1, [200], seed=81)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    bad = torch.from_numpy(pay[:, : -L + 1]).to(cuda_device).contiguous()
    with pytest.raises(ValueError, match="trailing zero"):
        rans_drain(dev, dev.init_lanes(bad), bad,
                   torch.from_numpy(idx).to(cuda_device), 200)
