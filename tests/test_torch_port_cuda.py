"""The port's hand-written kernels against their plain versions, on the
card: B1 (rANS drain; every lane count and both table routes), B2 (GDN), B3 (5×5 stride-2 conv), B4/B5 (window
attention, head widths 8, 24 and 48), B6 (stride-1 conv) and g_s's Up5
deconv, and the gradients of B2-B6 and Up5 through their
autograd.Functions; then the paths
around them: tuning, C5, mixed rates, the EB table, a ``.ltcp`` stream
written on the card and decoded on the CPU, the HAN tail on the card
against its CPU run, the U-Net-hyper and latent-U-Net presets'
stages against their CPU run and one training step each on the card;
the rbs g_s and ChARM without LRP against their CPU run (B6 at the
``ResidualBlockUpsample`` shapes, an rbs training step), the dormant
layers against their CPU run, and a ``CheckpointManager`` resume.
Every test here is
marked ``cuda`` and skips without CUDA.  fp32 tolerance: atol/rtol 1e-5
(sums in another order than cuDNN's / cuBLAS's); a repeat call of B2-B6 is
bit-identical; B1 is bit-exact.  Gradients: within 1e-5 of float64 as a
share of each gradient's range (conv weight gradients 1e-4: cuDNN's fp32
sum over B·H·W), and within 1e-6 of autograd of the plain version in fp32.

The file imports no jax, so it also runs on a GPU host without the JAX
package (``tests/conftest.py`` imports jax; pass ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from lic_tpu_torch.coding import (
    DeviceRans16Interleaved,
    GaussianCoder,
    GaussianMuCoder,
    drain_plain,
    random_streams,
    rans_drain,
)
from lic_tpu_torch.coding import drain as drain_mod
from lic_tpu_torch.layers import (
    conv5s2,
    conv5s2_plain,
    convk_s1,
    convk_s1_plain,
    gdn_fused,
    gdn_plain,
    up5,
    up5_plain,
    wba_plain,
    wba_proj_plain,
    window_attention,
    window_attention_proj,
)
from lic_tpu_torch.layers.window_attn import swin_shift_mask
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import set_numerics_flags

pytestmark = pytest.mark.cuda

L = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    set_numerics_flags()  # no TF32 in the plain versions' cuDNN/cuBLAS calls
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


# the GDN/IGDN shapes of a B=8 512×768 forward: (rows, C, inverse)
_GDN_PATH = [(786432, 192, False), (196608, 192, False), (49152, 192, False),
             (49152, 192, True), (196608, 192, True), (786432, 192, True),
             (3145728, 16, True)]


def _gdn_case(rows, c, seed, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=g)
    gamma = 0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)
    beta = 1.0 + torch.rand(c, generator=g)
    return x.to(dev), gamma.to(dev), beta.to(dev)


@pytest.mark.parametrize("rows,c,inverse", _GDN_PATH)
def test_gdn_kernel_at_path_shapes_vs_float64(cuda_device, rows, c, inverse):
    """The 7 shapes of the forward, against the plain version in float64:
    3xTF32 with an fp32 sum per 32-channel chunk (C = 192) and the CUDA-core
    kernel (C = 16) keep 1e-5."""
    x, gamma, beta = _gdn_case(rows, c, rows + c, cuda_device)
    _check_kernel(gdn_fused, gdn_plain, (x, gamma, beta, inverse), f64=True)


@pytest.mark.parametrize("c,rows", [(16, 3000), (192, 5000)])
def test_gdn_kernel_repeatable_and_rows_independent(cuda_device, c, rows):
    """A repeat is bit-identical, and a row's output does not depend on the
    rows around it (ragged tiles at both ends of the slice)."""
    x, gamma, beta = _gdn_case(rows, c, 7, cuda_device)
    with torch.no_grad():
        y = gdn_fused(x, gamma, beta, False)
        assert torch.equal(gdn_fused(x, gamma, beta, False), y)
        assert torch.equal(gdn_fused(x[1001:].clone(), gamma, beta, False), y[1001:])
        assert torch.equal(gdn_fused(x[37:1001].clone(), gamma, beta, False), y[37:1001])


@pytest.mark.parametrize("c", [16, 192])
def test_gdn_kernel_follows_gamma_rebuilt_at_the_same_address(cuda_device, c):
    """Γ is a fresh tensor every forward and the allocator reuses its
    address: the kernel splits Γ on every call, so a Γ rewritten in place,
    or freed and rebuilt, gives the new Γ's output."""
    x, gamma, beta = _gdn_case(1000, c, 11, cuda_device)
    with torch.no_grad():
        y0 = gdn_fused(x, gamma, beta, False)
        ptr = gamma.data_ptr()
        gamma.mul_(3.0).add_(0.05)
        assert gamma.data_ptr() == ptr
        y1 = gdn_fused(x, gamma, beta, False)
        torch.testing.assert_close(y1, gdn_plain(x, gamma, beta, False), atol=TOL, rtol=TOL)
        assert not torch.equal(y1, y0)
        del gamma
        gamma2 = 0.2 * torch.eye(c, device=cuda_device) + 0.03
        y2 = gdn_fused(x, gamma2, beta, True)
        torch.testing.assert_close(y2, gdn_plain(x, gamma2, beta, True), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("c,rows", [(8, 1000), (32, 1000), (100, 777), (96, 130)])
def test_gdn_kernel_other_widths(cuda_device, c, rows):
    """C = 8 on the CUDA cores (16 lanes of the row, half unused); on the
    tensor cores C = 32 (one K-chunk), C = 100 (a K-chunk and an N-tile cut
    short) and C = 96 (one N-tile)."""
    x, gamma, beta = _gdn_case(rows, c, c, cuda_device)
    for inverse in (False, True):
        _check_kernel(gdn_fused, gdn_plain, (x, gamma, beta, inverse), f64=True)


def test_gdn_kernel_rejects_unsupported_widths(cuda_device):
    for c in (130, 256):
        x, gamma, beta = _gdn_case(8, c, 0, cuda_device)
        with torch.no_grad(), pytest.raises(ValueError, match="gdn kernel takes C"):
            gdn_fused(x, gamma, beta, False)


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
        before = drain_mod.table_routes["smem"].launches
        k_lanes, k_dec = rans_drain(dev, k_lanes, payt, rows, m)
        torch.cuda.synchronize()
        assert drain_mod.table_routes["smem"].launches == before + 1
        p_lanes, p_dec = drain_plain(dev, p_lanes, payt, rows, m)
        assert torch.equal(k_dec, p_dec)
        assert torch.equal(k_lanes.state, p_lanes.state)
        assert torch.equal(k_lanes.ptr, p_lanes.ptr)
        np.testing.assert_array_equal(k_dec.cpu().numpy(), sym[:, off : off + m])
        off += m
    assert bool((k_lanes.state == 1 << 16).all())
    assert k_lanes.ptr.tolist() == ends


def _drain_vs_plain(dev, payt, idx, steps, lanes=None):
    """Drain ``steps`` symbols per call with the kernel and the plain
    version, threading each one's lane state; every call bit-exact.
    → (kernel lanes, decoded (B, sum(steps)) numpy)."""
    k_lanes = p_lanes = lanes if lanes is not None else dev.init_lanes(payt)
    off, decs = 0, []
    for m in steps:
        rows = torch.from_numpy(idx[:, off : off + m].copy()).to(payt.device)
        k_lanes, k_dec = rans_drain(dev, k_lanes, payt, rows, m)
        p_lanes, p_dec = drain_plain(dev, p_lanes, payt, rows, m)
        assert torch.equal(k_dec, p_dec)
        assert torch.equal(k_lanes.state, p_lanes.state)
        assert torch.equal(k_lanes.ptr, p_lanes.ptr)
        decs.append(k_dec.cpu().numpy())
        off += m
    return k_lanes, np.concatenate(decs, 1)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("with_escapes", [False, True])
def test_drain_kernel_bitexact_batches_and_escapes(cuda_device, b, with_escapes):
    """B = 1 and 8, no escapes and 1 symbol in 17 escaping; calls of s_tot
    not a multiple of L (one of them a single symbol) thread the state."""
    steps = [700, 129, 1, 300]
    coder = GaussianCoder()
    cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
    sym, idx, pay, ends = random_streams(
        cdfs, offsets, [(100 + i, with_escapes) for i in range(b)], steps, L)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    payt = torch.from_numpy(pay).to(cuda_device)
    lanes, dec = _drain_vs_plain(dev, payt, idx, steps)
    np.testing.assert_array_equal(dec, sym)
    assert bool((lanes.state == 1 << 16).all())
    assert lanes.ptr.tolist() == ends


@pytest.mark.parametrize("kind", ["flipped", "zeroed", "low_state"])
def test_drain_kernel_bitexact_on_corrupt_streams(cuda_device, kind):
    """Corrupt streams, trailing zeros kept, against the plain version:
    ``flipped`` xors bits into 30% of the words; ``zeroed`` zeroes each
    stream after its lane heads, so the pointer runs past W - L into the
    trailing zeros and past W (words there read 0); ``low_state`` starts
    lane 0 of stream 0 below 2^16 at the escape slot's start, so its state
    after the main phase is below 2^16 and the chunk takes the
    phase-by-phase escape path."""
    steps = [700]
    coder = GaussianCoder()
    cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
    _, idx, pay, ends = random_streams(cdfs, offsets, [(90, True), (91, False)], steps, L)
    rng = np.random.default_rng(5)
    bad = pay.copy()
    for b, end in enumerate(ends):
        if kind == "flipped":
            m = rng.random(end) < 0.3
            m[: 2 * L] = False
            bad[b, :end][m] ^= rng.integers(1, 1 << 16, int(m.sum())).astype(np.int32)
        elif kind == "zeroed":
            bad[b, 2 * L + 5 :] = 0
    if kind == "low_state":
        nsyms = cdfs.shape[1] - 2
        bad[0, 0], bad[0, 1] = 0, cdfs[idx[0, 0], nsyms]
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    payt = torch.from_numpy(bad).to(cuda_device)
    lanes, _ = _drain_vs_plain(dev, payt, idx, steps)
    if kind == "zeroed":
        assert int(lanes.ptr.max()) > bad.shape[1] - L


def test_drain_kernel_rechecks_trailing_zeros_after_in_place_write(cuda_device):
    """The trailing-zeros check runs once per payload tensor, and again once
    the tensor is written in place (its version counter moves)."""
    (cdfs, offsets), _, idx, pay, _ = _streams(1, [200], seed=82)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    payt = torch.from_numpy(pay).to(cuda_device)
    rows = torch.from_numpy(idx).to(cuda_device)
    rans_drain(dev, dev.init_lanes(payt), payt, rows, 200)
    payt[0, -1] = 7
    with pytest.raises(ValueError, match="trailing zero"):
        rans_drain(dev, dev.init_lanes(payt), payt, rows, 200)


def test_drain_kernel_rejects_payload_without_trailing_zeros(cuda_device):
    (cdfs, offsets), _, idx, pay, _ = _streams(1, [200], seed=81)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device=cuda_device)
    bad = torch.from_numpy(pay[:, : -L + 1]).to(cuda_device).contiguous()
    with pytest.raises(ValueError, match="trailing zero"):
        rans_drain(dev, dev.init_lanes(bad), bad,
                   torch.from_numpy(idx).to(cuda_device), 200)


@pytest.mark.parametrize("lanes", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("table", ["gaussian", "gaussian_mu"])
def test_drain_kernel_every_lane_count_and_table_route(cuda_device, lanes, table):
    """Every lane count the format's coders use, on the 64-row Gaussian
    table (in shared memory up to 128 lanes, in device memory at 256) and
    on ``GaussianMuCoder``'s 1,024 rows (always in device memory):
    stress streams (1 symbol in 17 escaping) and plain ones, calls of
    p_max·c = 4,224 symbols (a 512×768 wavefront) and of odd sizes
    threading the state, bit-exact against the plain version; each launch
    counted once in its route."""
    coder = GaussianCoder() if table == "gaussian" else GaussianMuCoder()
    cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
    steps = [4224, 37, 1, 700]
    sym, idx, pay, ends = random_streams(
        cdfs, offsets, [(200 + lanes, True), (300 + lanes, False)], steps, lanes)
    want = "global" if table == "gaussian_mu" or lanes == 256 else "smem"
    dev = DeviceRans16Interleaved(cdfs, offsets, lanes, device=cuda_device)
    assert drain_mod.route(dev) == want
    payt = torch.from_numpy(pay).to(cuda_device)
    before = {r: c.launches for r, c in drain_mod.table_routes.items()}
    lanes_out, dec = _drain_vs_plain(dev, payt, idx, steps)
    torch.cuda.synchronize()
    after = {r: c.launches for r, c in drain_mod.table_routes.items()}
    assert after[want] == before[want] + len(steps)
    assert sum(after.values()) == sum(before.values()) + len(steps)
    np.testing.assert_array_equal(dec, sym)
    assert bool((lanes_out.state == 1 << 16).all())
    assert lanes_out.ptr.tolist() == ends


def test_drain_kernel_rejects_other_lane_counts(cuda_device):
    (cdfs, offsets), _, idx, pay, _ = _streams(1, [200], seed=83)
    # zeros past the stream: room for 512 lanes' heads
    payt = torch.nn.functional.pad(torch.from_numpy(pay), (0, 1024)).to(cuda_device)
    rows = torch.from_numpy(idx).to(cuda_device)
    for lanes in (4, 48, 512):
        dev = DeviceRans16Interleaved(cdfs, offsets, lanes, device=cuda_device)
        with pytest.raises(ValueError, match=f"L={lanes}"):
            rans_drain(dev, dev.init_lanes(payt), payt, rows, 200)


TOL = 1e-5


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def _cl(t, dev):
    return t.to(dev).contiguous(memory_format=torch.channels_last)


def _f64(a):
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def _check_kernel(fn, plain, args, kwargs=None, f64=False):
    """kernel vs plain at TOL — the plain version run in float64 on the same
    inputs if ``f64`` — one launch counted, repeat bit-identical."""
    kwargs = kwargs or {}
    with torch.no_grad():
        before = fn.launches
        y = fn(*args, **kwargs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        if f64:
            ref = plain(*map(_f64, args), **{k: _f64(v) for k, v in kwargs.items()})
            torch.testing.assert_close(y.double(), ref, atol=TOL, rtol=TOL)
        else:
            torch.testing.assert_close(y, plain(*args, **kwargs), atol=TOL, rtol=TOL)
        assert torch.equal(fn(*args, **kwargs), y)
    return y


@pytest.mark.parametrize("cin,h,w", [(192, 16, 24), (128, 10, 6)])
def test_conv5s2_kernel_matches_plain(cuda_device, cin, h, w):
    g = torch.Generator().manual_seed(cin + h)
    x = _cl(_randn(g, 2, cin, h, w), cuda_device)
    wt = _randn(g, 192, cin, 5, 5, scale=(cin * 25) ** -0.5).to(cuda_device)
    b = _randn(g, 192).to(cuda_device)
    y = _check_kernel(conv5s2, conv5s2_plain, (x, wt, b), f64=True)
    assert y.shape == (2, 192, h // 2, w // 2)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("act,residual", [(None, False), ("leaky_relu", False), ("leaky_relu", True)])
def test_convk_s1_kernel_matches_plain(cuda_device, k, act, residual):
    g = torch.Generator().manual_seed(k)
    x = _cl(_randn(g, 2, 192, 12, 20), cuda_device)
    wt = _randn(g, 192, 192, k, k, scale=(192 * k * k) ** -0.5).to(cuda_device)
    b = _randn(g, 192).to(cuda_device)
    res = _cl(_randn(g, 2, 192, 12, 20), cuda_device) if residual else None
    _check_kernel(convk_s1, convk_s1_plain, (x, wt, b), dict(act=act, residual=res), f64=True)


def test_convk_s1_kernel_other_widths(cuda_device):
    """C_in 160 (not a multiple of the 16-channel stage), C_out 224 (the
    slice-0 ChARM conv), no bias."""
    g = torch.Generator().manual_seed(5)
    x = _cl(_randn(g, 1, 160, 9, 7), cuda_device)
    wt = _randn(g, 224, 160, 3, 3, scale=(160 * 9) ** -0.5).to(cuda_device)
    _check_kernel(convk_s1, convk_s1_plain, (x, wt, None), f64=True)


def test_conv_kernels_batch_independent_and_reject_layout(cuda_device):
    """An image's output does not depend on the batch it rides in (the
    encoder and decoder of one stream may run at other batch sizes), and a
    tensor that is not channels_last raises instead of being copied."""
    g = torch.Generator().manual_seed(9)
    x = _cl(_randn(g, 3, 192, 8, 12), cuda_device)
    wt = _randn(g, 192, 192, 3, 3, scale=(192 * 9) ** -0.5).to(cuda_device)
    w5 = _randn(g, 192, 192, 5, 5, scale=(192 * 25) ** -0.5).to(cuda_device)
    with torch.no_grad():
        assert torch.equal(convk_s1(x, wt)[1:2], convk_s1(x[1:2], wt))
        assert torch.equal(conv5s2(x, w5)[2:], conv5s2(x[2:], w5))
        with pytest.raises(ValueError, match="channels_last"):
            convk_s1(x.contiguous(), wt)


@pytest.mark.parametrize("slot,shape,k", [
    ("convk_s1", (1, 192, 32, 48), 7),    # the WAM 7x7 at /16: K = 9,408
    ("conv5s2", (1, 192, 256, 384), 5),   # down1 at B=1
])
def test_conv_kernels_at_path_shapes_vs_float64(cuda_device, slot, shape, k):
    """The paths' largest K and largest B3 input, against the plain version
    run in float64 (3xTF32 with a per-tap fp32 sum keeps 1e-5 there)."""
    g = torch.Generator().manual_seed(k)
    x = _cl(_randn(g, *shape), cuda_device)
    wt = _randn(g, 192, shape[1], k, k, scale=(shape[1] * k * k) ** -0.5).to(cuda_device)
    b = _randn(g, 192).to(cuda_device)
    fn, plain = (convk_s1, convk_s1_plain) if slot == "convk_s1" else (conv5s2, conv5s2_plain)
    _check_kernel(fn, plain, (x, wt, b), f64=True)


def test_convk_s1_kernel_on_2x2_maps(cuda_device):
    """The neural-syntax context head's c2: C_in 192, 3×3 on 2×2 maps, in
    a batch of 8·24 = 192 patches (one wavefront step at 512×768) and of
    12,288 (the forward at B = 8), bias, against float64; its backward
    against autograd of the plain version."""
    g = torch.Generator().manual_seed(22)
    wt = _randn(g, 192, 192, 3, 3, scale=(192 * 9) ** -0.5).to(cuda_device)
    b = _randn(g, 192).to(cuda_device)
    for n in (192, 12288):
        x = _cl(_randn(g, n, 192, 2, 2), cuda_device)
        _check_kernel(convk_s1, convk_s1_plain, (x, wt, b), f64=True)
    x = _cl(_randn(g, 192, 192, 2, 2), cuda_device).requires_grad_()
    w = wt.clone().requires_grad_()
    cot = _randn(g, 192, 192, 2, 2).to(cuda_device)
    got = torch.autograd.grad(convk_s1(x, w, b), (x, w), cot)
    x2, w2 = x.detach().double().requires_grad_(), w.detach().double().requires_grad_()
    ref = torch.autograd.grad(convk_s1_plain(x2, w2, b.double()), (x2, w2), cot.double())
    for a, r in zip(got, ref):
        assert float((a.double() - r).abs().max() / r.abs().max()) < 1e-4


def test_conv_kernel_prepack_follows_in_place_weight_update(cuda_device):
    """The TF32-split weights are cached on the weight: an in-place update
    between two calls must rebuild them."""
    g = torch.Generator().manual_seed(12)
    x = _cl(_randn(g, 2, 192, 8, 12), cuda_device)
    wt = _randn(g, 192, 192, 3, 3, scale=(192 * 9) ** -0.5).to(cuda_device)
    with torch.no_grad():
        y0 = convk_s1(x, wt)
        wt.mul_(-0.5)
        y1 = convk_s1(x, wt)
        torch.testing.assert_close(y1.double(), convk_s1_plain(x.double(), wt.double()),
                                   atol=TOL, rtol=TOL)
        torch.testing.assert_close(y1, -0.5 * y0, atol=TOL, rtol=TOL)


def test_conv_kernels_reject_cin_not_multiple_of_4(cuda_device):
    g = torch.Generator().manual_seed(13)
    x = _cl(_randn(g, 1, 130, 8, 12), cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="C_in 130"):
        convk_s1(x, _randn(g, 192, 130, 3, 3).to(cuda_device))
    with torch.no_grad(), pytest.raises(ValueError, match="C_in 130"):
        conv5s2(x, _randn(g, 192, 130, 5, 5).to(cuda_device))


def _attn_case(gen, dev, hp, wp, nh, ws, shift, pad):
    n = ws * ws
    rel = _randn(gen, nh, n, n, scale=0.5).to(dev)
    mask = None
    if shift or pad:
        mask = torch.from_numpy(
            swin_shift_mask(hp - pad, wp - pad, ws, shift, pad, pad)
        ).to(dev)
    return rel, mask


def _proj_weights(gen, dev, c):
    wqkv = _randn(gen, 3 * c, c, scale=c ** -0.5).to(dev)
    wproj = _randn(gen, c, c, scale=c ** -0.5).to(dev)
    return wqkv, _randn(gen, 3 * c).to(dev), wproj, _randn(gen, c).to(dev)


# several windows per image at both ws; (4, 12, 12) gives 9 windows per
# image, so B4/B5's four-window CTAs at ws 4 end on a partial CTA
@pytest.mark.parametrize("ws,hp,wp", [(8, 16, 24), (4, 8, 12), (4, 12, 12)])
@pytest.mark.parametrize("shift,pad", [(0, 0), (2, 0), (2, 3)])
@pytest.mark.parametrize("c,nh", [(192, 8), (16, 2), (384, 8)])  # hd 24, 8 and 48
def test_window_attention_kernels_match_plain(cuda_device, ws, hp, wp, shift, pad, c, nh):
    b = 2
    g = torch.Generator().manual_seed(ws + shift + pad + c)
    rel, mask = _attn_case(g, cuda_device, hp, wp, nh, ws, shift, pad)
    qkv = _randn(g, b, hp, wp, 3 * c).to(cuda_device)
    _check_kernel(window_attention, wba_plain, (qkv, rel, mask, ws, nh))
    x = _randn(g, b, hp, wp, c).to(cuda_device)
    wqkv, bqkv, wproj, bproj = _proj_weights(g, cuda_device, c)
    _check_kernel(window_attention_proj, wba_proj_plain,
                  (x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh))


@pytest.mark.parametrize("kernel", ["wba", "wba_proj"])
@pytest.mark.parametrize("ws,hp,wp", [(8, 16, 24), (4, 8, 12)])
def test_window_attention_kernels_batch_independent_and_repeatable(cuda_device, kernel, ws, hp, wp):
    """A repeat call is bit-identical, and an image's output does not
    depend on the batch it rides in (at ws 4 a CTA takes four windows,
    which then span two images), as for the convs."""
    c, nh = 192, 8
    g = torch.Generator().manual_seed(ws)
    rel, mask = _attn_case(g, cuda_device, hp, wp, nh, ws, 2, 0)
    if kernel == "wba":
        x = _randn(g, 3, hp, wp, 3 * c).to(cuda_device)
        fn = lambda t: window_attention(t, rel, mask, ws, nh)
    else:
        x = _randn(g, 3, hp, wp, c).to(cuda_device)
        w = _proj_weights(g, cuda_device, c)
        fn = lambda t: window_attention_proj(t, rel, *w, mask, ws, nh)
    with torch.no_grad():
        y = fn(x)
        assert torch.equal(fn(x), y)
        assert torch.equal(fn(x[1:2].clone()), y[1:2])
        assert torch.equal(fn(x[1:].clone()), y[1:])


def test_window_attention_kernels_reject_unsupported_head_width(cuda_device):
    """hd is a template constant of both kernels: hd 32 (C 192, 6 heads)
    raises; B5 also needs one of its built (C, hd) pairs."""
    g = torch.Generator().manual_seed(1)
    rel = _randn(g, 6, 64, 64).to(cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="head width"):
        window_attention(_randn(g, 1, 8, 8, 3 * 192).to(cuda_device), rel, None, 8, 6)
    with torch.no_grad(), pytest.raises(ValueError, match="head width"):
        window_attention_proj(_randn(g, 1, 8, 8, 192).to(cuda_device), rel,
                              *_proj_weights(g, cuda_device, 192), None, 8, 6)
    rel4 = _randn(g, 4, 64, 64).to(cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="head width"):
        window_attention_proj(_randn(g, 1, 8, 8, 32).to(cuda_device), rel4,
                              *_proj_weights(g, cuda_device, 32), None, 8, 4)


def test_window_attention_per_head_softmax_no_underflow(cuda_device):
    """One head's logits ~90 below another's must not underflow to 0/0:
    the softmax takes each head's own row max
    (``tests/test_pallas.py::test_per_head_softmax_shift_no_underflow``),
    in B4 and in B5."""
    ws, nh, c, n = 4, 2, 16, 16
    g = torch.Generator().manual_seed(0)
    qkv = _randn(g, 1, 4, 4, 3 * c, scale=0.1).to(cuda_device)
    x = _randn(g, 1, 4, 4, c, scale=0.1).to(cuda_device)
    w = _proj_weights(g, cuda_device, c)
    rel = torch.zeros(nh, n, n)
    rel[1] -= 90.0
    rel = rel.to(cuda_device)
    with torch.no_grad():
        y = window_attention(qkv, rel, None, ws, nh)
        assert torch.isfinite(y).all()
        torch.testing.assert_close(y, wba_plain(qkv, rel, None, ws, nh), atol=TOL, rtol=TOL)
        y = window_attention_proj(x, rel, *w, None, ws, nh)
        assert torch.isfinite(y).all()
        torch.testing.assert_close(y, wba_proj_plain(x, rel, *w, None, ws, nh),
                                   atol=TOL, rtol=TOL)


def test_default_build_lands_on_cuda(cuda_device):
    """``build_model`` with no device builds on the card."""
    model = build_model("source_net", n_override=32)
    assert {p.device.type for p in model.parameters()} == {"cuda"}


# g_s's four _Up5 deconvs at 512×768 (C_in, C_out, input H, W): the last
# gives M = 16 channels to the generated conv, or RGB; and neural syntax's
# first (C_in 176)
UP5_GS = [(192, 192, 32, 48), (192, 192, 64, 96), (192, 192, 128, 192), (192, 16, 256, 384),
          (192, 3, 256, 384), (176, 192, 32, 48)]


def _up5_args(g, dev, b, cin, cout, h, w):
    return (_cl(_randn(g, b, cin, h, w), dev),
            _randn(g, cin, cout, 5, 5, scale=(cin * 25 / 4) ** -0.5).to(dev),
            _randn(g, cout).to(dev))


@pytest.mark.parametrize("cin,cout,h,w", UP5_GS)
def test_up5_kernel_at_gs_shapes_vs_float64(cuda_device, cin, cout, h, w):
    """Up5 at g_s's shapes (B = 2) against its plain version in float64,
    one launch, a repeat bit-identical; the output interleaved in place,
    ``channels_last``."""
    g = torch.Generator().manual_seed(cin + cout + h)
    y = _check_kernel(up5, up5_plain, _up5_args(g, cuda_device, 2, cin, cout, h, w), f64=True)
    assert y.shape == (2, cout, 2 * h, 2 * w)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("cin,cout,h,w", [(192, 192, 7, 9), (8, 12, 5, 27), (12, 3, 9, 4),
                                         (16, 20, 3, 30), (8, 9, 4, 5)])
def test_up5_kernel_ragged_maps_and_narrow_widths(cuda_device, cin, cout, h, w):
    """Maps that are no multiple of the 8×24 patch, on each tile width
    (C_out 3 and 8: 8 wide; 9 and 12: 16 wide; 20: 96 wide), C_out that
    is no multiple of 4 (scalar stores)."""
    g = torch.Generator().manual_seed(h * w)
    _check_kernel(up5, up5_plain, _up5_args(g, cuda_device, 3, cin, cout, h, w), f64=True)


@pytest.mark.parametrize("cout", [192, 16, 3])
def test_up5_image_alone_equals_the_image_in_a_batch_of_8(cuda_device, cout):
    """An image's Up5 output does not depend on the batch it rides in (§C5),
    on each tile width."""
    g = torch.Generator().manual_seed(cout)
    x, wt, b = _up5_args(g, cuda_device, 8, 192, cout, 32, 48)
    with torch.no_grad():
        y = up5(x, wt, b)
        for i in (0, 5):
            assert torch.equal(up5(x[i : i + 1], wt, b), y[i : i + 1])


def test_up5_rejects_cin_not_multiple_of_4_and_up5_module_keeps_cudnn(cuda_device):
    """The wrapper raises on C_in 6; an ``_Up5`` of C_in 6 takes ``F.pad`` +
    ``F.conv_transpose2d`` on the card, with no launch."""
    from lic_tpu_torch.models.transforms import _Up5

    g = torch.Generator().manual_seed(6)
    x, wt, b = _up5_args(g, cuda_device, 1, 6, 8, 8, 12)
    with torch.no_grad(), pytest.raises(ValueError, match="C_in 6"):
        up5(x, wt, b)
    m = _Up5(6, 8, g).to(cuda_device)
    with torch.no_grad():
        before = up5.launches
        y = m(x)
        torch.cuda.synchronize()
        assert up5.launches == before
        ref = torch.nn.functional.conv_transpose2d(torch.nn.functional.pad(x, (1, 0, 1, 0)),
                                                   m.deconv.weight, m.deconv.bias, 2, 3, 1)
        torch.testing.assert_close(y, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("opt", ["in_place", "torch_fused"])
def test_up5_reads_the_weight_after_an_update(cuda_device, opt):
    """Up5 caches its weight's phase-packed split: after an in-place update
    or a fused Adam step (which leaves the version counter) the kernel
    equals the plain version with the new weight (float64), not the old."""
    g = torch.Generator().manual_seed(17)
    x, wt, b = _up5_args(g, cuda_device, 2, 192, 192, 8, 12)
    wt = torch.nn.Parameter(wt)
    with torch.no_grad():
        up5(x, wt, b)  # packs the weight
        old = wt.detach().clone()
    if opt == "in_place":
        with torch.no_grad():
            wt.mul_(-0.5)
    else:
        optimizer = torch.optim.Adam([wt], lr=1e-2, fused=True)
        wt.grad = torch.ones_like(wt)
        optimizer.step()
    with torch.no_grad():
        y = up5(x, wt, b)
        ref = up5_plain(x.double(), wt.double(), b.double())
        torch.testing.assert_close(y.double(), ref, atol=TOL, rtol=TOL)
        assert float((y.double() - up5_plain(x.double(), old.double(), b.double()))
                     .abs().max()) > 10 * TOL


# ------------------------------------------------- bf16 and the plain routes

# one bf16 rounding of the output (half an ulp: 2**-9 of the value) over
# the fp32 kernel's own error
BF16_RTOL, BF16_ATOL = 2 ** -8, 1e-5


@pytest.mark.parametrize("kernel", ["conv5s2", "convk_s1", "wba", "wba_proj"])
def test_kernels_take_bf16(cuda_device, kernel):
    """B3-B6 on bf16 tensors: widened to fp32 at the kernel, the output
    rounded back to bf16 (bf16 operands, an fp32 sum, a bf16 result),
    against the plain version run in float64 on the same bf16 values (the
    plain version in bf16 rounds every intermediate, and is the less exact
    side); one launch counted."""
    g = torch.Generator().manual_seed(21)
    bf = lambda t: t.bfloat16()
    if kernel == "conv5s2":
        fn, plain = conv5s2, conv5s2_plain
        args = (bf(_cl(_randn(g, 2, 192, 16, 24), cuda_device)),
                bf(_randn(g, 192, 192, 5, 5, scale=(192 * 25) ** -0.5).to(cuda_device)),
                bf(_randn(g, 192).to(cuda_device)))
    elif kernel == "convk_s1":
        fn, plain = convk_s1, convk_s1_plain
        args = (bf(_cl(_randn(g, 2, 192, 12, 20), cuda_device)),
                bf(_randn(g, 192, 192, 3, 3, scale=(192 * 9) ** -0.5).to(cuda_device)),
                bf(_randn(g, 192).to(cuda_device)), "leaky_relu",
                bf(_cl(_randn(g, 2, 192, 12, 20), cuda_device)))
    else:
        rel, mask = _attn_case(g, cuda_device, 16, 24, 8, 8, 4, 0)
        if kernel == "wba":
            fn, plain = window_attention, wba_plain
            args = (bf(_randn(g, 2, 16, 24, 3 * 192).to(cuda_device)), bf(rel), mask, 8, 8)
        else:
            fn, plain = window_attention_proj, wba_proj_plain
            w = [bf(t) for t in _proj_weights(g, cuda_device, 192)]
            args = (bf(_randn(g, 2, 16, 24, 192).to(cuda_device)), bf(rel), *w, mask, 8, 8)
    with torch.no_grad():
        before = fn.launches
        y = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and y.dtype == torch.bfloat16
        torch.testing.assert_close(y.double(), plain(*map(_f64, args)), atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("c,route", [(192, "kernel"), (16, "kernel"), (384, "plain"),
                                     (18, "plain")])
def test_gdn_module_takes_the_plain_route_where_gated(cuda_device, c, route):
    """``GDN`` runs B2 where ``b2_takes(C)``, else ``gdn_plain_route``."""
    from lic_tpu_torch.layers import GDN
    from lic_tpu_torch.layers.gdn import gdn_plain_route

    m = GDN(c).to(cuda_device)
    g = torch.Generator().manual_seed(c)
    x = _cl(_randn(g, 2, c, 6, 10), cuda_device)
    with torch.no_grad():
        k0, p0 = gdn_fused.launches, gdn_plain_route.launches
        y = m(x)
        torch.cuda.synchronize()
        assert (gdn_fused.launches - k0, gdn_plain_route.launches - p0) == (
            (1, 0) if route == "kernel" else (0, 1))
        ref = gdn_plain(x.permute(0, 2, 3, 1).reshape(-1, c), m._gamma_rp(m.gamma),
                        m._beta_rp(m.beta), False).view(2, 6, 10, c).permute(0, 3, 1, 2)
        torch.testing.assert_close(y, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("c,ws,h,w,fuse,route", [
    (192, 8, 16, 24, False, "wba"),
    (192, 4, 8, 12, True, "wba_proj"),
    (64, 4, 8, 12, True, "wba"),        # B5 lacks (64, 8): B4 between the Linears
    (64, 4, 64, 64, True, "raises"),    # ... at 4096 tokens: B5 raises
    (96, 4, 32, 48, False, "plain"),    # hd 12
    (512, 2, 8, 12, True, "plain"),     # hd 64
    (384, 8, 64, 64, False, "wba"),     # hd 48 at 4096 tokens: B4
    (384, 8, 64, 64, True, "wba_proj"),  # ... and B5 at (384, 48)
    (256, 8, 64, 64, False, "raises"),  # hd 32 at 4096 tokens
])
def test_window_attention_takes_the_plain_route_where_gated(cuda_device, c, ws, h, w, fuse,
                                                            route):
    """``WinBasedAttention`` on the card: B5, B4 or ``wba_plain_route`` by
    the gate, each counted once; the output equals the CPU module's."""
    from lic_tpu_torch.layers import WinBasedAttention
    from lic_tpu_torch.layers.win_attention import wba_plain_route

    gen = torch.Generator().manual_seed(c + ws)
    m = WinBasedAttention(c, 8, ws, ws // 2, generator=gen)
    torch.nn.init.normal_(m.attn.proj.weight, 0.0, c ** -0.5, generator=gen)
    m.attn.fuse_proj = fuse
    x = _randn(gen, 1, c, h, w).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = m(x)
        m = m.to(cuda_device)
        xc = x.to(cuda_device)
        if route == "raises":
            with pytest.raises(ValueError, match="head width"):
                m(xc)
            return
        counts = lambda: (window_attention.launches, window_attention_proj.launches,
                          wba_plain_route.launches)
        before = counts()
        y = m(xc)
        torch.cuda.synchronize()
        grew = tuple(a - b for a, b in zip(counts(), before))
        assert grew == {"wba": (1, 0, 0), "wba_proj": (0, 1, 0), "plain": (0, 0, 1)}[route]
        torch.testing.assert_close(y.cpu(), ref, atol=1e-4, rtol=1e-4)


def test_conv_with_cin_not_multiple_of_4_takes_cudnn(cuda_device):
    """``Conv2d`` keeps C_in 130 out of both kernel slots: no launch, the
    cuDNN result."""
    from lic_tpu_torch.layers import Conv2d

    g = torch.Generator().manual_seed(130)
    for m, x in ((Conv2d(130, 192, 3, 1, 1, generator=g), _randn(g, 1, 130, 8, 12)),
                 (Conv2d(130, 192, 5, 2, (1, 2, 1, 2), generator=g), _randn(g, 1, 130, 8, 12))):
        m = m.to(cuda_device).to(memory_format=torch.channels_last)
        x = _cl(x, cuda_device)
        with torch.no_grad():
            before = (conv5s2.launches, convk_s1.launches)
            y = m(x)
            torch.cuda.synchronize()
            assert (conv5s2.launches, convk_s1.launches) == before
            pad = m.padding
            xp = torch.nn.functional.pad(x, pad) if isinstance(pad, tuple) else x
            ref = torch.nn.functional.conv2d(xp, m.weight, m.bias, m.stride,
                                             0 if isinstance(pad, tuple) else pad)
            torch.testing.assert_close(y, ref, atol=TOL, rtol=TOL)


# ------------------------------------------------------------- training


def _share(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _grad_case(kernel, dev, g):
    """(wrapper on the differentiable tensors, plain version on them, the
    tensors, index of a conv weight or None, closed-form backward or None)."""
    from lic_tpu_torch.layers import conv_direct, gdn as gdn_mod

    cl = lambda t: t.contiguous(memory_format=torch.channels_last).to(dev)
    if kernel == "gdn":
        x, gamma, beta = _gdn_case(3000, 192, 3, dev)
        return (lambda *t: gdn_fused(*t, False), None, [x, gamma, beta], None,
                lambda cot, *t: gdn_mod.gdn_plain_backward(cot, *t, False))
    if kernel == "conv5s2":
        ts = [cl(_randn(g, 2, 192, 16, 24)), cl(_randn(g, 160, 192, 5, 5, scale=4800 ** -0.5)),
              _randn(g, 160).to(dev)]
        return conv5s2, conv5s2_plain, ts, 1, None
    if kernel == "up5":
        ts = [cl(_randn(g, 2, 192, 16, 24)), _randn(g, 192, 160, 5, 5, scale=1200 ** -0.5).to(dev),
              _randn(g, 160).to(dev)]
        deconv = lambda x, w, b: torch.nn.functional.conv_transpose2d(
            torch.nn.functional.pad(x, (1, 0, 1, 0)), w, b, 2, 3, 1)
        return up5, deconv, ts, 1, None
    if kernel == "convk_s1":
        ts = [cl(_randn(g, 2, 192, 12, 20)), cl(_randn(g, 192, 192, 3, 3, scale=1728 ** -0.5)),
              _randn(g, 192).to(dev), cl(_randn(g, 2, 192, 12, 20))]
        fn = lambda x, w, b, r: conv_direct.convk_s1(x, w, b, "leaky_relu", r)
        plain = lambda x, w, b, r: convk_s1_plain(x, w, b, "leaky_relu", r)
        return fn, plain, ts, 1, None
    c, nh, ws = 192, 8, 8
    rel, mask = _attn_case(g, dev, 16, 24, nh, ws, 4, 0)
    if kernel == "wba":
        return (lambda q, r: window_attention(q, r, mask, ws, nh),
                lambda q, r: wba_plain(q, r, mask, ws, nh),
                [_randn(g, 2, 16, 24, 3 * c).to(dev), rel], None, None)
    ts = [_randn(g, 2, 16, 24, c).to(dev), rel, *_proj_weights(g, dev, c)]
    return (lambda *t: window_attention_proj(*t, mask, ws, nh),
            lambda *t: wba_proj_plain(*t, mask, ws, nh), ts, None, None)


@pytest.mark.parametrize("kernel", ["gdn", "conv5s2", "convk_s1", "wba", "wba_proj", "up5"])
def test_kernel_backward_matches_plain_autograd(cuda_device, kernel):
    """The gradient of a random cotangent through the kernel's
    autograd.Function (forward: the kernel, counted; backward: the plain
    gradient, counted in ``backwards``) against autograd of the plain
    version in float64 (B2: its closed form in float64; Up5: autograd of
    ``F.pad`` + ``F.conv_transpose2d``) and in fp32."""
    from lic_tpu_torch.layers import conv_direct, gdn as gdn_mod, window_attn as wa

    counter = {"gdn": gdn_mod.gdn_fused, "conv5s2": conv_direct.conv5s2,
               "convk_s1": conv_direct.convk_s1, "wba": wa.window_attention,
               "wba_proj": wa.window_attention_proj, "up5": conv_direct.up5}[kernel]
    g = torch.Generator().manual_seed(len(kernel))
    fn, plain, ts, weight_at, closed = _grad_case(kernel, cuda_device, g)
    ins = [t.detach().requires_grad_() for t in ts]
    l0, b0 = counter.launches, counter.backwards
    y = fn(*ins)
    cot = _randn(g, *y.shape).to(cuda_device)
    got = torch.autograd.grad(y, ins, cot)
    torch.cuda.synchronize()
    assert (counter.launches - l0, counter.backwards - b0) == (1, 1)
    if closed is not None:
        ref = closed(cot.double(), *[t.double() for t in ts])
        ref32 = closed(cot, *ts)
    else:
        i64 = [t.detach().double().requires_grad_() for t in ts]
        ref = torch.autograd.grad(plain(*i64), i64, cot.double())
        i32 = [t.detach().requires_grad_() for t in ts]
        ref32 = torch.autograd.grad(plain(*i32), i32, cot)
    for i, (a, b, b32) in enumerate(zip(got, ref, ref32)):
        assert _share(a, b) <= (1e-4 if i == weight_at else 1e-5), (i, _share(a, b))
        assert _share(a, b32) <= 1e-6, (i, _share(a, b32))


@pytest.mark.parametrize("opt", ["trainer", "torch_foreach", "torch_fused"])
def test_conv_kernels_read_the_weights_after_an_optimizer_step(cuda_device, opt):
    """B3/B6 cache their weights' TF32 split: after one optimizer step (the
    trainer's, and torch's Adam foreach and fused) the kernels' output
    equals the plain version with the new weights (float64), not the old."""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.layers import Conv2d
    from lic_tpu_torch.training import make_optimizer

    g = torch.Generator().manual_seed(5)
    model = torch.nn.Sequential(Conv2d(192, 192, 5, 2, (1, 2, 1, 2), generator=g),
                                Conv2d(192, 160, 3, 1, 1, fused_act="leaky_relu", generator=g))
    model = model.to(cuda_device).to(memory_format=torch.channels_last)
    x = _randn(g, 2, 192, 16, 24).to(cuda_device).contiguous(memory_format=torch.channels_last)
    assert [m.kernel_slot(t) for m, t in ((model[0], x), (model[1], model[0](x)))] == [
        "conv5s2", "convk_s1"]
    if opt == "trainer":
        optimizer = make_optimizer(model, TrainConfig(lr=1e-3), steps_per_epoch=10)
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                     **{"foreach" if opt == "torch_foreach" else "fused": True})
    model(x).square().mean().backward()  # the forward packs the weights
    before = [m.weight.detach().clone() for m in model]
    optimizer.step()
    with torch.no_grad():
        h = x
        for m, old in zip(model, before):
            y = m(h)
            plain = conv5s2_plain if m.stride == 2 else convk_s1_plain
            extra = () if m.stride == 2 else ("leaky_relu",)
            ref = plain(h.double(), m.weight.double(), m.bias.double(), *extra)
            torch.testing.assert_close(y.double(), ref, atol=TOL, rtol=TOL)
            assert float((y.double() - plain(h.double(), old.double(), m.bias.double(),
                                            *extra)).abs().max()) > 10 * TOL
            h = y


# ------------------------------------------------------------ eval and C5


@pytest.fixture
def source_net_on_card(cuda_device):
    """Full-width ``source_net`` (B3 runs at C_in 192) and two smooth
    128×128 images on the card."""
    from lic_tpu_torch.data import smooth_images

    model = build_model("source_net", seed=0)
    x = torch.from_numpy(smooth_images(np.random.default_rng(0), 2, 128, 128))
    return model, _cl(x, cuda_device)


def _b3_b6_outputs_vs_f64(model, dev):
    """Each g_a conv that takes B3 or B6 on a seeded input: → [(kernel
    output − plain version in float64 with the conv's current weights) max,
    the output]."""
    from lic_tpu_torch.layers import Conv2d

    g = torch.Generator().manual_seed(9)
    out = []
    with torch.no_grad():
        for m in model.g_a.modules():
            if not isinstance(m, Conv2d):
                continue
            x = _cl(_randn(g, 1, m.weight.shape[1], 32, 32), dev)
            slot = m.kernel_slot(x)
            if slot is None:
                continue
            plain = conv5s2_plain if slot == "conv5s2" else convk_s1_plain
            extra = () if slot == "conv5s2" else (m.fused_act,)
            y = m(x)
            ref = plain(x.double(), m.weight.double(), m.bias.double(), *extra)
            out.append((float((y.double() - ref).abs().max()), y))
    return out


def test_tuning_on_the_card_moves_g_a_only(source_net_on_card):
    from lic_tpu_torch.config import EvalConfig
    from lic_tpu_torch.evaluation import content_adaptive_finetune

    model, x = source_net_on_card
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tuned = content_adaptive_finetune(model, x[:1], EvalConfig(tune_iters=3, tune_lr_drop_step=2))
    after = tuned.state_dict()
    for name, v in after.items():
        if not name.startswith("g_a."):
            assert torch.equal(v, before[name]), name
    assert any(not torch.equal(after[k], before[k]) for k in after if k.startswith("g_a."))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert [p.requires_grad for p in tuned.parameters()] == [
        p.requires_grad for p in model.parameters()]


def test_conv_kernels_read_the_tuned_then_the_checkpoint_weights(source_net_on_card):
    """B3/B6 cache each weight's TF32 split: the tuned copy's g_a convs
    read the tuned weights, and the model's own (the checkpoint's, which
    the next image starts from) read the checkpoint's again."""
    from lic_tpu_torch.config import EvalConfig
    from lic_tpu_torch.evaluation import content_adaptive_finetune

    model, x = source_net_on_card
    dev = x.device
    first = _b3_b6_outputs_vs_f64(model, dev)  # packs the checkpoint's weights
    assert first
    tuned = content_adaptive_finetune(model, x[:1], EvalConfig(tune_iters=3, tune_lr=1e-3))
    for (err, y_tuned), (_, y_first) in zip(_b3_b6_outputs_vs_f64(tuned, dev), first):
        assert err <= TOL, err
        assert float((y_tuned - y_first).abs().max()) > 10 * TOL
    for (err, y), (_, y_first) in zip(_b3_b6_outputs_vs_f64(model, dev), first):
        assert err <= TOL, err
        assert torch.equal(y, y_first)


def test_decompress_batch_of_single_streams_is_bitidentical(source_net_on_card):
    """Fault C5 on the card: streams encoded one at a time, decoded in one
    batch, in chunks and alone, give the same bits (and the same bytes as
    a batch encode)."""
    from lic_tpu_torch.models.compress import ChannelCoder

    model, x = source_net_on_card
    x = torch.cat([x, x.flip(-1), x.flip(-2)]).contiguous(memory_format=torch.channels_last)
    coder = ChannelCoder(model, name="source_net")
    singles = [coder.compress(x[i : i + 1]) for i in range(len(x))]
    assert singles == coder.compress_batch(x)
    together = coder.decompress_batch(singles)
    alone = torch.cat([coder.decompress(s) for s in singles])
    chunks = torch.cat([coder.decompress_batch(singles[:4]), coder.decompress_batch(singles[4:])])
    assert torch.equal(together, alone) and torch.equal(together, chunks)


def test_decompress_batch_launches_up5_once_per_up5(source_net_on_card):
    """``source_net``'s ``decompress_batch`` runs g_s once per pass: its
    four ``_Up5`` deconvs launch Up5 exactly 4 times, and its compress
    none."""
    from lic_tpu_torch.models.compress import ChannelCoder

    model, x = source_net_on_card
    coder = ChannelCoder(model, name="source_net")
    before = up5.launches
    streams = coder.compress_batch(x)
    torch.cuda.synchronize()
    assert up5.launches == before
    coder.decompress_batch(streams)
    torch.cuda.synchronize()
    assert up5.launches == before + 4


def test_mixed_rate_batch_on_the_card_equals_per_image(cuda_device):
    """``source_net_vr`` on the card: a mixed-rate ``compress_batch``
    gives each image's ``compress`` alone at its rate, and its decode is
    the batch decode of those streams, bit for bit."""
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models.compress import ChannelCoder

    model = build_model("source_net_vr", seed=0)
    x = _cl(torch.from_numpy(smooth_images(np.random.default_rng(1), 3, 128, 128)), cuda_device)
    coder = ChannelCoder(model, name="source_net_vr")
    rates = [0.0, 1.5, 3.0]
    blobs = coder.compress_batch(x, rates=rates)
    assert blobs == [coder.compress(x[i : i + 1], rate=r) for i, r in enumerate(rates)]
    assert len(blobs[0]) < len(blobs[2])
    together = coder.decompress_batch(blobs)
    assert torch.equal(together, torch.cat([coder.decompress(b) for b in blobs]))


def test_eb_table_on_the_card_equals_the_cpu(cuda_device):
    """The factorized prior's pmf table, CDFs and digest from a model on
    the card equal those of the same weights on the CPU (ROADMAP §C7)."""
    from lic_tpu_torch.models.compress import ChannelCoder

    cpu = build_model("source_net", device="cpu", seed=3)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in cpu.entropy_bottleneck.named_parameters():
            if name.startswith("factor_"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    card = build_model("source_net", seed=3)
    card.load_state_dict(cpu.state_dict())
    t_cpu, t_card = cpu.eb_pmf_table(-128, 127), card.eb_pmf_table(-128, 127)
    assert t_card.device.type == "cpu" and torch.equal(t_card, t_cpu)
    c_cpu, c_card = ChannelCoder(cpu), ChannelCoder(card)
    assert np.array_equal(c_card.z_coder.codec.cdfs, c_cpu.z_coder.codec.cdfs)
    assert c_card.digest == c_cpu.digest


@pytest.mark.parametrize("digit_model", ["gaussian", "static"])
def test_ltcp_roundtrip_on_the_card_and_decoded_on_the_cpu(cuda_device, digit_model, capsys):
    """A ``.ltcp`` stream written on the card: its full decode on the card
    equals the card's eval forward within 1e-4 (the coder's passes of 8);
    the CPU model of the same weights either decodes it within 1e-4 of the
    card at every truncation point or raises at the host codec's
    final-state check (ROADMAP §C8); which one is printed."""
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models.compress import _passes, pass_batch
    from lic_tpu_torch.models.progressive import ProgressiveCoder
    from lic_tpu_torch.tools.batch_probe import wake_eb

    card = build_model("source_net", seed=0)
    cpu = build_model("source_net", device="cpu", seed=0)
    wake_eb(card)
    wake_eb(cpu)
    x = _cl(torch.from_numpy(smooth_images(np.random.default_rng(2), 1, 256, 384)), cuda_device)
    coder = ProgressiveCoder(card, name="source_net", digit_model=digit_model)
    blob = coder.compress(x)
    with torch.no_grad():
        ref = _passes(lambda t: card(t).x_tilde, pass_batch(256, 384, x.device), x)
    assert float((coder.decompress(blob) - ref).abs().max()) <= 1e-4
    cpu_coder = ProgressiveCoder(cpu, name="source_net", digit_model=digit_model)
    outcome = "equal"
    for n, _ in coder.truncation_points(blob):
        try:
            got = cpu_coder.decompress(blob, n)
        except ValueError as e:
            assert "final-state" in str(e)
            outcome = f"raised at {n} planes"
            break
        assert float((got - coder.decompress(blob, n).cpu()).abs().max()) <= 1e-4, n
    with capsys.disabled():
        print(f"\n[c8 ltcp] {digit_model}: the CPU decode of the card's stream: {outcome}")


def test_han_head_on_the_card_equals_its_cpu_run(cuda_device):
    """``HANHead`` (every zero-init leaf woken) on the card against the same
    weights on the CPU: within 1e-4 of the output's largest magnitude, in
    eval; the input gradient of a random cotangent in the training
    forward (each RCAB checkpointed) likewise, in float64 on both sides:
    in fp32 a ReLU whose input lies within rounding of 0 can take the other
    branch on one device and move the gradient by more."""
    from lic_tpu_torch.models.han import HANHead

    g = torch.Generator().manual_seed(1)
    cpu = HANHead(generator=g)
    with torch.no_grad():
        for p in cpu.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    card = HANHead().to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = _randn(g, 2, 3, 64, 96)
    ct = _randn(g, 2, 64, 64, 96)
    with torch.no_grad():
        want = cpu(x)
        got = card(_cl(x, cuda_device)).cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    grads = []
    for m, dev in ((cpu, torch.device("cpu")), (card, cuda_device)):
        m.double().train()
        xi = _cl(x.double(), dev).requires_grad_(True)
        m(xi).backward(_cl(ct.double(), dev))
        grads.append(xi.grad.cpu())
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-4 * float(grads[0].abs().max())



def _woken_pair(name, dev, seed=0):
    """Preset ``name`` at full width on the CPU, every all-zero weight woken
    with seeded values of gain 0.5 (as ``chip_smoke.py`` wakes them), and
    the same weights on the card."""
    cpu = build_model(name, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 5)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("weight") and not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5 * p[0].numel() ** -0.5)
    card = build_model(name, device=dev, seed=seed + 1)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("name", ["net_unet", "net_unet_ha_hs"])
def test_unet_presets_on_the_card_equal_their_cpu_run(cuda_device, name):
    """The latent-U-Net and U-Net-hyper presets at full width, 128×128,
    eval: z3, the hyper's (scales, means) and the synthesis of the CPU's
    ŷ on the card within 1e-4 of each one's largest magnitude on the CPU,
    the latent U-Net's and the U-Net decoder's inputs taken from the
    CPU's z3 (no rounding between)."""
    cpu, card = _woken_pair(name, cuda_device)
    x = _randn(torch.Generator().manual_seed(3), 1, 3, 128, 128).clamp(-1, 1)
    with torch.no_grad():
        out = cpu(x)
        z3 = cpu.analyze(x)
        want = {"z3": z3, **dict(zip(("scales", "means"), cpu.hyper_forward(z3)[:2])),
                "rec": cpu.synthesize(out.extras["y_hat"], cpu.syntax_from_latent(z3))}
        got = {"z3": card.analyze(_cl(x, cuda_device)),
               **dict(zip(("scales", "means"), card.hyper_forward(_cl(z3, cuda_device))[:2])),
               "rec": card.synthesize(_cl(out.extras["y_hat"], cuda_device),
                                      _cl(cpu.syntax_from_latent(z3), cuda_device))}
    errs = {k: (float((got[k].cpu() - v).abs().max()), float(v.abs().max()))
            for k, v in want.items()}
    assert all(e <= 1e-4 * m for e, m in errs.values()), errs


@pytest.mark.parametrize("name", ["net_unet", "net_unet_ha_hs", "net_unet_ha_hs_1"])
def test_unet_training_step_on_the_card(cuda_device, name):
    """One training step on the card (B = 2, 128×128): a finite loss,
    every B2 and B6 launch with its backward, every leaf that took a
    gradient moved, and the leaves no forward reads (``net_unet_ha_hs_1``'s
    syntax model) bit-identical without a gradient."""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.layers import conv_direct
    from lic_tpu_torch.layers import gdn as gdn_mod
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    _, card = _woken_pair(name, cuda_device)
    card.train()
    x = _randn(torch.Generator().manual_seed(4), 2, 3, 128, 128).clamp(-1, 1)
    tc = TrainConfig()
    opt = make_optimizer(card, tc, steps_per_epoch=10)
    state = create_state(card, opt, tc.seed)
    before = {n: p.detach().clone() for n, p in card.named_parameters()}
    counted = (gdn_mod.gdn_fused, conv_direct.convk_s1)
    for fn in counted:
        fn.launches = fn.backwards = 0
    metrics = make_train_step(card, tc, opt)(state, _cl(x, cuda_device))
    torch.cuda.synchronize()
    assert float(metrics["skipped"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    assert all(fn.launches == fn.backwards > 0 for fn in counted)
    unread = set(card.unread_parameters())
    assert bool(unread) == (name == "net_unet_ha_hs_1")
    for n, p in card.named_parameters():
        if n in unread:
            assert p.grad is None and torch.equal(p, before[n]), n
        elif p.grad is not None and p.grad.any():
            assert not torch.equal(p, before[n]), n


# ------------------------------------------ the rbs g_s and ChARM without LRP

_NEW_CONFIGS = {"rbs": ("net_ga", dict(transform="rbs")),
                "nolrp": ("source_net", dict(lrp=False))}
# one B = 1 eval forward: net_ga's kernels, and the rbs g_s's three
# ResidualBlockUpsamples (a B6 3x3 and a B2 IGDN each); source_net's
_NEW_LAUNCHES = {"rbs": {"gdn": 12, "conv5s2": 2, "convk_s1": 66, "wba": 20, "up5": 1},
                 "nolrp": {"gdn": 7, "conv5s2": 3, "convk_s1": 5, "wba": 0, "up5": 4}}


def _woken_config(name, dev, seed=0):
    preset, over = _NEW_CONFIGS[name]
    cpu = build_model(preset, device="cpu", seed=seed, **over)
    g = torch.Generator().manual_seed(seed + 5)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("weight") and not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5 * p[0].numel() ** -0.5)
    card = build_model(preset, device=dev, seed=seed + 1, **over)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("name", list(_NEW_CONFIGS))
def test_rbs_and_nolrp_on_the_card_equal_their_cpu_run(cuda_device, name):
    """Full width, 128×128, eval: z3, the hyper's (scales, means), slice
    0's (μ, σ) and the synthesis of the CPU's ŷ on the card within 1e-4 of
    each one's largest magnitude on the CPU; the forward's exact launches.
    The rbs synthesis block by block (each child of g_s, then the
    generated conv before its tanh, on the CPU's input to it): its IGDNs
    square the map's scale, and ``wam1``'s attention logits reach 1e4 on
    a map of magnitude ≈ 200, where fp32 keeps ≈ 1e-2 of the output's
    range on the CPU as on the card; a block whose CPU run lies farther
    than 5e-5 from float64 is held as within twice that distance of
    float64 on the card."""
    from lic_tpu_torch.layers import conv_direct
    from lic_tpu_torch.layers import gdn as gdn_mod
    from lic_tpu_torch.layers import window_attn
    from lic_tpu_torch.models.syntax import batch_conv

    cpu, card = _woken_config(name, cuda_device)
    x = _randn(torch.Generator().manual_seed(3), 1, 3, 128, 128).clamp(-1, 1)

    def blocks(m, y, syn, ins=None):
        """g_s's children (each on ``ins[i]`` where given), then the
        generated conv before its tanh → (inputs, outputs)."""
        dev = syn.device
        inputs, outputs, h = [], [], y
        for i, layer in enumerate(m.g_s.children()):
            xin = h if ins is None else _cl(ins[i], dev)
            inputs.append(xin)
            h = layer(xin)
            outputs.append(h)
        last = h if ins is None else _cl(ins[-1], dev)
        inputs.append(last)
        outputs.append(batch_conv(m.conv_weights_gen(syn), last))
        return inputs, outputs

    def stages(m, xin, z3, y, syn, ins=None):
        med = m.eb_medians()[None, :, None, None]
        scales, means = m.hyper_decode(torch.round(m.hyper_encode(z3) - med) + med)
        mu, sigma, _ = m.charm_entropy_params(means, scales, [], 0)
        st = {"z3": m.analyze(xin), "scales": scales, "means": means, "mu0": mu,
              "sigma0": sigma}
        if name == "rbs":
            st.update({f"g_s block {i}": o for i, o in enumerate(blocks(m, y, syn, ins)[1])})
        else:
            st["synthesis"] = m.synthesize(y, syn)
        return st

    counted = {"gdn": gdn_mod.gdn_fused, "conv5s2": conv_direct.conv5s2,
               "convk_s1": conv_direct.convk_s1, "wba": window_attn.window_attention,
               "up5": conv_direct.up5}
    with torch.no_grad():
        out = cpu(x)
        z3 = cpu.analyze(x)
        syn = cpu.syntax_from_latent(z3)
        want = stages(cpu, x, z3, out.extras["y_hat"], syn)
        ins = blocks(cpu, out.extras["y_hat"], syn)[0] if name == "rbs" else None
        got = stages(card, _cl(x, cuda_device), _cl(z3, cuda_device),
                     _cl(out.extras["y_hat"], cuda_device), _cl(syn, cuda_device), ins)
        for fn in counted.values():
            fn.launches = 0
        y = card(_cl(x, cuda_device))
        torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in counted.items()} == _NEW_LAUNCHES[name]
    assert torch.isfinite(y.x_tilde).all() and y.x_tilde.shape == (1, 3, 128, 128)
    ref = {}
    if name == "rbs":
        import copy

        with torch.no_grad():
            c64 = copy.deepcopy(cpu).double()
            outs = blocks(c64, None, syn.double(), [t.double() for t in ins])[1]
        ref = {f"g_s block {i}": o for i, o in enumerate(outs)}
    errs = {k: (float((got[k].cpu() - v).abs().max()), float(v.abs().max()))
            for k, v in want.items()}
    for k, (e, m) in errs.items():
        if k in ref and float((want[k].double() - ref[k]).abs().max()) > 5e-5 * m:
            cpu_f64 = float((want[k].double() - ref[k]).abs().max())
            assert float((got[k].cpu().double() - ref[k]).abs().max()) <= 2 * cpu_f64, k
        else:
            assert e <= 1e-4 * m, (k, e, m)


@pytest.mark.parametrize("h,w", [(64, 96), (128, 192), (256, 384)])
def test_convk_s1_at_the_residual_block_upsample_shapes(cuda_device, h, w):
    """B6 at the rbs g_s's ResidualBlockUpsample 3×3 (C 192 → 192, bias,
    no activation) at 512×768's three scales, against the plain version in
    float64."""
    g = torch.Generator().manual_seed(h)
    x = _cl(_randn(g, 1, 192, h, w), cuda_device)
    wt = _randn(g, 192, 192, 3, 3, scale=(192 * 9) ** -0.5).to(cuda_device)
    b = _randn(g, 192).to(cuda_device)
    _check_kernel(convk_s1, convk_s1_plain, (x, wt, b), f64=True)


def test_rbs_training_step_on_the_card(cuda_device):
    """One training step of the rbs config on the card (B = 2, 128×128):
    a finite loss, every B2 and B6 launch with its backward, every leaf
    whose gradient after the global-norm clip exceeds 1e-6 somewhere
    moved.  (Adam's first step moves a leaf by ≈ lr·g / (|g| + 1e-8):
    below ε a leaf of magnitude 1 does not move in fp32, and the rbs
    loss's gradient norm, which the clip divides by, is large on these
    weights.)"""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.layers import conv_direct
    from lic_tpu_torch.layers import gdn as gdn_mod
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    _, card = _woken_config("rbs", cuda_device)
    card.train()
    x = _randn(torch.Generator().manual_seed(4), 2, 3, 128, 128).clamp(-1, 1)
    tc = TrainConfig()
    opt = make_optimizer(card, tc, steps_per_epoch=10)
    state = create_state(card, opt, tc.seed)
    before = {n: p.detach().clone() for n, p in card.named_parameters()}
    counted = (gdn_mod.gdn_fused, conv_direct.convk_s1)
    for fn in counted:
        fn.launches = fn.backwards = 0
    metrics = make_train_step(card, tc, opt)(state, _cl(x, cuda_device))
    torch.cuda.synchronize()
    assert float(metrics["skipped"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    assert gdn_mod.gdn_fused.launches == gdn_mod.gdn_fused.backwards == 12
    assert conv_direct.convk_s1.launches == conv_direct.convk_s1.backwards == 66
    moved = 0
    for n, p in card.named_parameters():
        if p.grad is not None and float(p.grad.abs().max()) > 1e-6:
            assert not torch.equal(p, before[n]), n
            moved += 1
    assert moved > 100


# ------------------------------------------------------- the dormant layers


def _dormant_cases():
    from lic_tpu_torch.layers import GDN1, misc, vit

    g = lambda i: torch.Generator().manual_seed(i)
    return {
        "GDN1": lambda: GDN1(192),
        "GDN1_inverse": lambda: GDN1(192, inverse=True),
        "vit_latent_syntax": lambda: vit.vit_latent_syntax(16, generator=g(1)),
        "MaskedConv2d": lambda: misc.MaskedConv2d(192, 192, 5, "A", generator=g(2)),
        "GSDN": lambda: misc.GSDN(192),
        "LinearAttention": lambda: misc.LinearAttention(192, generator=g(3)),
        "SpatialSelfAttention": lambda: misc.SpatialSelfAttention(192, generator=g(4)),
        "BlockTrain": lambda: misc.BlockTrain(192, 96, 16 * 24, embed_dim=192, num_heads=12,
                                              generator=g(5)),
        "UnetHaHs": lambda: misc.UnetHaHs(generator=g(6)),
    }


@pytest.mark.parametrize("name", list(_dormant_cases()))
def test_dormant_module_on_the_card_equals_its_cpu_run(cuda_device, name):
    """Each module on the card within 1e-4 of its CPU run's largest
    magnitude, the same weights and input."""
    import copy

    m = _dormant_cases()[name]().eval()
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in m.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    shape = (2, 3, 16, 16) if name == "vit_latent_syntax" else (2, 192, 16, 24)
    x = _randn(gen, *shape).clamp(-2, 2)
    with torch.no_grad():
        want = m(x)
        got = copy.deepcopy(m).to(cuda_device)(_cl(x, cuda_device))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_haar_and_erf_on_the_card_equal_the_cpu(cuda_device):
    from lic_tpu_torch.layers import haar
    from lic_tpu_torch.layers.conv import Conv2d
    from lic_tpu_torch.utils.analyze import effective_receptive_field

    x = _randn(torch.Generator().manual_seed(8), 2, 3, 64, 96)
    assert torch.equal(haar.haar_dwt2(x.to(cuda_device)).cpu(), haar.haar_dwt2(x))
    net = Conv2d(3, 192, 3, 1, 1, generator=torch.Generator().manual_seed(9))
    want = effective_receptive_field(net, x)
    got = effective_receptive_field(net.to(cuda_device), x.to(cuda_device))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# --------------------------------------------------------- resuming training


def test_checkpoint_resume_on_the_card_is_bit_identical(cuda_device, tmp_path):
    """source_net at full width, B = 2 crops of 128×128: three steps
    straight, against two steps, a save, a fresh model, optimizer and state
    restored from the file and a third step: the parameters bit-identical."""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step
    from lic_tpu_torch.utils.checkpoint import CheckpointManager

    tc = TrainConfig()
    g = torch.Generator().manual_seed(10)
    batches = [_cl(_randn(g, 2, 3, 128, 128).clamp(-1, 1), cuda_device) for _ in range(3)]

    def fresh():
        model = build_model("source_net", device=cuda_device).train()
        opt = make_optimizer(model, tc, steps_per_epoch=10)
        return model, create_state(model, opt, tc.seed), make_train_step(model, tc, opt)

    straight, state_a, step_a = fresh()
    for b in batches:
        step_a(state_a, b)
    _, state_b, step_b = fresh()
    for b in batches[:2]:
        step_b(state_b, b)
    CheckpointManager(str(tmp_path)).save(state_b, 2)
    resumed, state_c, step_c = fresh()
    CheckpointManager(str(tmp_path)).restore(state_c, 2)
    step_c(state_c, batches[2])
    assert state_c.step == 3
    for (n, p), (_, q) in zip(straight.named_parameters(), resumed.named_parameters()):
        assert torch.equal(p, q), n


def test_cpu_written_state_resumes_on_the_card_with_its_seed(cuda_device, tmp_path):
    """A file whose noise generator was a CPU one (as the Orbax tool writes
    it) seeds the card's generator with that generator's seed."""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.training import create_state, make_optimizer
    from lic_tpu_torch.utils.checkpoint import CheckpointManager

    tc = TrainConfig()
    cpu = build_model("source_net", device="cpu", n_override=32)
    state = create_state(cpu, make_optimizer(cpu, tc, 10), tc.seed)
    state.generator.manual_seed(123456789012345)
    CheckpointManager(str(tmp_path)).save(state, 0)
    card = build_model("source_net", device=cuda_device, n_override=32)
    target = create_state(card, make_optimizer(card, tc, 10), tc.seed)
    CheckpointManager(str(tmp_path)).restore(target, 0)
    assert target.generator.device.type == "cuda"
    assert target.generator.initial_seed() == 123456789012345
