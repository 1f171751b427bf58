"""Port parity: the plain versions of kernels B3 and B6, and ``Conv2d``'s
routing of its kernel slots, against the JAX package on the CPU.

* ``conv5s2_plain`` against ``conv5s2_pallas(interpret=True)``,
  ``conv5s2_pallas_v2(interpret=True)`` and ``lax.conv``;
* ``convk_s1_plain`` (bias, LeakyReLU, residual) against
  ``convk_s1_pallas(..., interpret=True)`` and ``lax.conv``;
* ``Conv2d`` sends exactly the shapes to B3/B6 that the JAX ``Conv2d``
  sends to its Pallas kernels, and its ``fused_act`` matches the JAX
  module's with the packed path on (``set_packed_conv(True,
  interpret=True)``, restored in ``finally``).

C = 192 on small spatial sizes, weights scaled by 1/sqrt(fan-in) so the
outputs are O(1); tolerance atol/rtol 1e-5 (fp32 sums in another order).
The CUDA kernels are held to these plain versions by
``tests/test_torch_port_cuda.py``.

The kernels run 3xTF32; what of that runs on the CPU is held here: the
TF32 split (round to nearest even, reconstruction, special values), the
weight prepack's OHWI layout and its cache, and a float64 emulation of the
3xTF32 conv against the float64 conv (the error model the kernel rests on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lic_tpu.layers.conv as jconv
from lic_tpu.layers.pallas_conv import conv5s2_pallas, conv5s2_pallas_v2
from lic_tpu.layers.pallas_conv_s1 import convk_s1_pallas
import torch.nn.functional as F

from lic_tpu_torch.layers import Conv2d, conv5s2_plain, convk_s1_plain
from lic_tpu_torch.layers import conv as tconv
from lic_tpu_torch.layers.conv_direct import pack_weight, prepacked, tf32_round, tf32_split

torch.set_num_threads(2)

TOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _lax(x, k, stride, pad):
    return lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def _case(seed, shape, k, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, shape[-1], cout)) * (shape[-1] * k * k) ** -0.5)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, w.astype(np.float32), b


@pytest.mark.parametrize("shape", [(2, 8, 12, 192), (1, 6, 10, 128)])
def test_conv5s2_plain_matches_pallas_and_lax(shape):
    x, w, _ = _case(1, shape, 5, 192)
    got = _nhwc(conv5s2_plain(_nchw(x), _oihw(w)))
    ref = np.asarray(_lax(x, w, 2, ((1, 2), (1, 2))))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    for fn in (conv5s2_pallas, conv5s2_pallas_v2):
        pal = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), interpret=True))
        np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("k", [3, 7])
def test_convk_s1_plain_matches_pallas_epilogue(k):
    x, w, b = _case(k, (1, 8, 12, 192), k, 192)
    got = convk_s1_plain(_nchw(x), _oihw(w), torch.from_numpy(b), act="leaky_relu",
                         residual=_nchw(x))
    pal = convk_s1_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          act="leaky_relu", residual=True, interpret=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(pal), atol=TOL, rtol=TOL)
    ref = jax.nn.leaky_relu(_lax(x, w, 1, "SAME") + b) + x
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=TOL, rtol=TOL)
    bare = convk_s1_plain(_nchw(x), _oihw(w))
    np.testing.assert_allclose(_nhwc(bare), np.asarray(_lax(x, w, 1, "SAME")),
                               atol=TOL, rtol=TOL)


def _switches():
    """The JAX conv module's global switches, shared by every test of a
    worker process."""
    return (jconv._PALLAS_CONV, jconv._PALLAS_INTERPRET,
            jconv._PACKED_CONV, jconv._PACKED_INTERPRET)


def _restore(saved):
    jconv.set_pallas_conv(saved[0], saved[1])
    jconv.set_packed_conv(saved[2], saved[3])


# (kernel, stride, padding, C_in, H, W): the B3 and B6 gates' edges
_ROUTES = [
    (5, 2, (1, 2, 1, 2), 192, 8, 12),   # B3
    (5, 2, (1, 2, 1, 2), 128, 8, 12),   # B3 at the C_in floor
    (5, 2, (1, 2, 1, 2), 96, 8, 12),    # below it: plain
    (5, 2, (1, 2, 1, 2), 192, 7, 12),   # odd H: plain
    (5, 2, 2, 192, 8, 12),              # symmetric pad (h_a): plain
    (3, 1, 1, 192, 6, 10),              # B6
    (7, 1, 3, 192, 6, 10),              # B6
    (5, 1, 2, 160, 6, 10),              # B6
    (3, 1, 1, 128, 6, 10),              # C_in = 128: plain
    (3, 1, 1, 240, 6, 10),              # C_in > 192: plain
    (1, 1, 0, 192, 6, 10),              # 1x1: plain
    (3, 2, 1, 192, 6, 10),              # strided 3x3: plain
]


@pytest.mark.parametrize("k,stride,pad,cin,h,w", _ROUTES)
def test_conv2d_routes_kernel_slots_like_jax(monkeypatch, k, stride, pad, cin, h, w):
    """Stub both packages' kernel entry points and record which slot each
    module picks for the same conv; the JAX switches are restored after."""
    hits = {"jax": None, "torch": None}

    def spy(pkg, slot, out):
        def f(*a, **kw):
            hits[pkg] = slot
            return out(*a)
        return f

    j_zeros = lambda x, kern, *rest: jnp.zeros(
        (x.shape[0], -(-x.shape[1] // stride), -(-x.shape[2] // stride), kern.shape[-1]),
        x.dtype,
    )
    t_zeros = lambda x, wt, *rest: torch.zeros(
        (x.shape[0], wt.shape[0], -(-x.shape[2] // stride), -(-x.shape[3] // stride))
    )
    monkeypatch.setattr(jconv, "_conv5s2_fast", spy("jax", "B3", j_zeros))
    monkeypatch.setattr(jconv, "_convs1_packed_ba", spy("jax", "B6", j_zeros))
    monkeypatch.setattr(tconv, "conv5s2", spy("torch", "B3", t_zeros))
    monkeypatch.setattr(tconv, "convk_s1", spy("torch", "B6", t_zeros))
    saved = _switches()
    jconv.set_pallas_conv(True)
    jconv.set_packed_conv(True)
    try:
        x = jnp.zeros((1, h, w, cin), jnp.float32)
        m = jconv.Conv2d(192, kernel_size=k, stride=stride, padding=pad)
        m.apply(m.init(jax.random.PRNGKey(0), x), x)
    finally:
        _restore(saved)
    tm, xt = Conv2d(cin, 192, k, stride, pad), torch.zeros(1, cin, h, w)
    with torch.no_grad():
        tm(xt)
    assert hits["torch"] == hits["jax"], hits
    assert tm.kernel_slot(xt) == {"B3": "conv5s2", "B6": "convk_s1", None: None}[hits["jax"]]


@pytest.mark.parametrize("k,pad", [(3, 1), (7, 3)])
def test_conv2d_fused_act_matches_jax_packed_path(k, pad):
    x, _, _ = _case(20 + k, (1, 6, 10, 192), k, 192)
    m = jconv.Conv2d(192, kernel_size=k, padding=pad, fused_act="leaky_relu")
    params = m.init(jax.random.PRNGKey(k), jnp.asarray(x))
    rng = np.random.default_rng(k)
    params = {"params": {
        "kernel": params["params"]["kernel"],
        "bias": jnp.asarray(rng.standard_normal(192).astype(np.float32)),
    }}
    saved = _switches()
    jconv.set_packed_conv(True, interpret=True)
    try:
        ref = np.asarray(m.apply(params, jnp.asarray(x)))
    finally:
        _restore(saved)
    tm = Conv2d(192, 192, k, 1, pad, fused_act="leaky_relu")
    with torch.no_grad():
        tm.weight.copy_(_oihw(params["params"]["kernel"]))
        tm.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def _tf32_rne_reference(a: np.ndarray) -> np.ndarray:
    """Round fp32 to a 10-bit mantissa, ties to even, from the two TF32
    neighbours of each value compared in float64 (finite inputs)."""
    bits = a.view(np.uint32).astype(np.int64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    down = mag & ~0x1FFF
    up = down + 0x2000
    as_f64 = lambda m: (m | sign).astype(np.uint32).view(np.float32).astype(np.float64)
    d_dn = np.abs(a.astype(np.float64) - as_f64(down))
    d_up = np.abs(as_f64(up) - a.astype(np.float64))
    take_up = (d_up < d_dn) | ((d_up == d_dn) & ((down >> 13) & 1 == 1))
    return (np.where(take_up, up, down) | sign).astype(np.uint32).view(np.float32)


def test_tf32_split_rounds_to_nearest_even_and_reconstructs():
    rng = np.random.default_rng(40)
    a = (rng.standard_normal(20000) * 2.0 ** rng.integers(-60, 60, 20000)).astype(np.float32)
    # exact ties: the 13 dropped bits are 0x1000, below an even and an odd kept bit
    tie = np.array([0x3F801000, 0x3F803000, 0xBF801000, 0xBF803000], np.uint32).view(np.float32)
    a = np.concatenate([a, tie])
    hi, lo = tf32_split(torch.from_numpy(a))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  _tf32_rne_reference(a).view(np.uint32))
    np.testing.assert_array_equal(hi[-4:].numpy(), np.float32([1.0, 1.0 + 2 ** -9,
                                                               -1.0, -1.0 - 2 ** -9]))
    err = np.abs(hi.double().numpy() + lo.double().numpy() - a.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(a)).all(), err.max()
    assert torch.equal(tf32_round(hi), hi)


def test_tf32_split_special_values():
    """Signed zeros keep their sign in hi (lo is +0); subnormals round on
    TF32's grid and reconstruct within 2**-137; ±inf and NaN go to hi with
    lo 0 (NaN as the canonical quiet NaN)."""
    z = torch.tensor([0.0, -0.0])
    hi, lo = tf32_split(z)
    assert torch.signbit(hi).tolist() == [False, True]
    assert lo.tolist() == [0.0, 0.0] and not torch.signbit(lo).any()
    sub = torch.from_numpy(np.array([1, 0xFFF, 0x1000, 0x3000, 0x7FFFFF, 0x80001234],
                                    np.uint32).view(np.float32))
    hi, lo = tf32_split(sub)
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  _tf32_rne_reference(sub.numpy()).view(np.uint32))
    err = (hi.double() + lo.double() - sub.double()).abs()
    assert float(err.max()) <= 2.0 ** -137
    bad = torch.from_numpy(np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001],
                                    np.uint32).view(np.float32))
    hi, lo = tf32_split(bad)
    assert hi[:2].tolist() == [float("inf"), float("-inf")]
    assert torch.isnan(hi[2:]).all() and (hi[2:].view(torch.int32) == 0x7FC00000).all()
    assert lo.tolist() == [0.0] * 4


def test_weight_prepack_is_ohwi_and_cached():
    g = torch.Generator().manual_seed(41)
    w = torch.randn(224, 160, 3, 3, generator=g) * (160 * 9) ** -0.5
    hi, lo = pack_weight(w)
    ohwi = w.permute(0, 2, 3, 1)
    assert hi.shape == lo.shape == (224, 3, 3, 160) and hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi, tf32_round(ohwi))
    torch.testing.assert_close(hi.double() + lo.double(), ohwi.double(), atol=0,
                               rtol=2.0 ** -22)
    got = prepacked(w)
    assert all(a is b for a, b in zip(prepacked(w), got))
    with torch.no_grad():
        w.mul_(-0.5)  # in place: the version counter moves
    hi2, _ = prepacked(w)
    assert hi2 is not got[0] and torch.equal(hi2, tf32_round(w.permute(0, 2, 3, 1)))


def test_3xtf32_conv_emulation_within_1e6_of_float64():
    """The 7×7 at C 192 (K = 9,408), B = 1, 8×8: three float64 convs on the
    split operands (hi·lo + lo·hi + hi·hi, the kernel's products) land within
    1e-6 of the float64 conv; one TF32 product alone does not come near."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((1, 192, 8, 8)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((192, 192, 7, 7)) * 9408 ** -0.5)
                         .astype(np.float32))
    conv = lambda a, b: F.conv2d(a.double(), b.double(), padding=3)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    ref = conv(x, w)
    emu = conv(xh, wl) + conv(xl, wh) + conv(xh, wh)
    assert float((emu - ref).abs().max()) <= 1e-6
    assert float((conv(xh, wh) - ref).abs().max()) > 1e-4
