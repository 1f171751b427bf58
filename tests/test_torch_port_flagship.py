"""Port parity: the flagship serving path against the JAX package, on the CPU.

``net_ga`` (rich g_a/g_s, the ELIC hyper, the SWAtten slice stacks, the WAM
syntax model) and ``net_unet_ha_hs_dec`` (the same with the decodable U-Net
hyper), each as one module-scoped JAX/port pair at ``n_override=32``,
128×128.  Weights come from the JAX init, carried over by
``params_from_flax``; every all-zero leaf (the zero-init residual outputs,
WMSA's ``linear``, the Swin ``mlp_fc2``, the biases) gets small random
values first, or it would hide its branch.  Tolerances:

* the blocks (``ResidualBottleneck``, ``ResidualBlockWithStride``,
  ``ResidualBlock3_5``/``5x5``/``3x3``, ``ResidualBlock``'s 1×1 skip,
  ``AttentionBlock`` with ``b_input``), ``SWAtten``, both hypers and the
  WAM syntax model: atol/rtol 1e-4, each on the same input;
* the whole eval forward: z3, μ, σ and x_tilde atol/rtol 1e-4, bpp rtol
  1e-4, and the symbols round(z3 − μ) equal to JAX's;
* the port's codec roundtrip decodes to its own forward within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.layers import blocks as jblocks
from lic_tpu.layers.swin import SWAtten as JSWAtten
from lic_tpu.models import hyper as jhyper
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.models.syntax import SyntaxModel as JSyntaxModel
from lic_tpu_torch.layers import ResidualBlock, ResidualBlock3_5, ResidualBlock5x5
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.utils.params import params_from_flax, state_from_flax
from jax_params import init_params, wake

torch.set_num_threads(2)

ATOL = 1e-4
N = 32


def _nchw(a):
    t = torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=ATOL)


def _pair(name):
    jm = JCodecModel(jget_config(name, n_override=N))
    params = wake(init_params(jm), 7)
    tm = build_model(name, device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params, PRESETS[name]))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    return jm, params, tm, x


@pytest.fixture(scope="module")
def net_ga():
    return _pair("net_ga")


@pytest.fixture(scope="module")
def unet_dec():
    return _pair("net_unet_ha_hs_dec")


def _module_case(jmod, jparams, tmod, shape, seed, *extra):
    """A JAX module and its port on the same seeded NHWC input(s)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in (shape,) + extra]
    want = jmod.apply({"params": jparams}, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tmod(*map(_nchw, xs))
    return got, want


def test_rich_g_a_blocks_match(net_ga):
    _, params, tm, _ = net_ga
    ga = params["g_a"]
    for name, jmod, shape in [
        ("rb0_1", jblocks.ResidualBottleneck(3), (1, 16, 16, 3)),
        ("rbs0", jblocks.ResidualBlockWithStride(N, 2), (1, 16, 16, 3)),
        ("rb1_2", jblocks.ResidualBottleneck(N), (1, 8, 8, N)),
        ("rbs1", jblocks.ResidualBlockWithStride(N, 2), (1, 8, 8, N)),
    ]:
        got, want = _module_case(jmod, ga[name], getattr(tm.g_a, name), shape, 1)
        _close(_nhwc(got), want)


@pytest.mark.parametrize("jcls,tcls,k", [
    (jblocks.ResidualBlock, ResidualBlock, 3),
    (jblocks.ResidualBlock3_5, ResidualBlock3_5, 5),
    (jblocks.ResidualBlock5x5, ResidualBlock5x5, 5),
])
def test_residual_blocks_with_1x1_skip_match(jcls, tcls, k):
    """A change of width: the 1×1 skip that no preset's block has."""
    x = np.random.default_rng(k).standard_normal((1, 6, 10, 12)).astype(np.float32)
    jmod = jcls(20)
    params = wake(jmod.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"], k)
    tmod = tcls(12, 20)
    tmod.load_state_dict(state_from_flax(params, tmod))
    assert tmod.skip is not None
    with torch.no_grad():
        got = tmod(_nchw(x))
    _close(_nhwc(got), jmod.apply({"params": params}, jnp.asarray(x)))


def test_swatten_and_attention_block_match(net_ga):
    """Slice 1's mean stack: C = N + N/4, Swin at window 8 on a 10×12 map
    (padded to the window grid, masked, cropped); the gate's b branch on
    another input."""
    _, params, tm, _ = net_ga
    c = N + N // 4
    got, want = _module_case(JSWAtten(c, c, head_dim=16, window_size=8, inter_dim=128),
                             params["atten_mean_1"], tm.atten_mean[1], (1, 10, 12, c), 2)
    _close(_nhwc(got), want)
    got, want = _module_case(jblocks.AttentionBlock(128), params["atten_scale_2"]["gate"],
                             tm.atten_scale[2].gate, (1, 8, 8, 128), 3, (1, 8, 8, 128))
    _close(_nhwc(got), want)


def test_elic_hyper_and_wam_syntax_match(net_ga):
    _, params, tm, _ = net_ga
    got, want = _module_case(jhyper.ElicHyperAnalysis(), params["h_a"], tm.h_a,
                             (1, 8, 8, N), 4)
    _close(_nhwc(got), want)
    got, want = _module_case(jhyper.ElicHyperSynthesis(N), params["h_scale_s"], tm.h_scale_s,
                             (1, 2, 3, 192), 5)
    _close(_nhwc(got), want)
    got, want = _module_case(JSyntaxModel(16, 16, "wam"), params["syntax_model"],
                             tm.syntax_model, (1, 12, 16, 16), 6)
    _close(_nhwc(got), want)


def test_unet_hyper_matches(unet_dec):
    """``UnetHyperAnalysis`` (attention at ws 4 / hd 2 and 16, ws 2 / hd 64)
    and the decodable two-head synthesis (ws 2 / hd 32 and 16)."""
    _, params, tm, _ = unet_dec
    got, want = _module_case(jhyper.UnetHyperAnalysis(N), params["h_a"], tm.h_a,
                             (1, 8, 12, N), 8)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    got, want = _module_case(jhyper.DecodableUnetHyperSynthesis(N, two_heads=True),
                             params["h_s"], tm.h_s, (1, 2, 3, 512), 9)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


@pytest.mark.parametrize("preset", ["net_ga", "unet_dec"])
def test_flagship_forward_and_codec_match(preset, request):
    jm, params, tm, x = request.getfixturevalue(preset)
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(
        params, jnp.asarray(x))
    z3j = np.asarray(jax.jit(lambda p, a: jm.apply(
        {"params": p}, a, method=JCodecModel.analyze))(params, jnp.asarray(x)))
    xt = _nchw(x)
    with torch.no_grad():
        ot = tm(xt)
        z3t = _nhwc(tm.analyze(xt))
    _close(z3t, z3j)
    mu_t, mu_j = _nhwc(ot.extras["means"]), np.asarray(oj.extras["means"])
    _close(mu_t, mu_j)
    _close(_nhwc(ot.extras["scales"]), oj.extras["scales"])
    np.testing.assert_array_equal(np.round(z3t - mu_t), np.round(z3j - mu_j))
    _close(_nhwc(ot.x_tilde), oj.x_tilde)
    np.testing.assert_allclose(float(ot.bpp), float(oj.bpp), rtol=1e-4)

    coder = ChannelCoder(tm, name=preset)
    rec = coder.decompress_batch(coder.compress_batch(xt))
    torch.testing.assert_close(rec, ot.x_tilde, atol=ATOL, rtol=0)
