"""Port repairs, on the CPU: where the JAX package computes a result and the
port used to raise.

* **bf16** (a bf16 forward). ``source_net`` and ``net_ga`` at
  ``n_override=32``, 128×128, run as ``model.to(torch.bfloat16)`` on a bf16
  input, against the JAX forward with ``bf16_params`` on the same bf16
  input. Both run every layer in bf16 (bf16 operands, fp32 sums, bf16
  results), in other orders and with other intermediate roundings (the JAX
  GDN rounds x², the norm and its square root to bf16; the port's plain GDN
  keeps the norm in fp32). The tolerance was fixed before the first run:
  each stage on the same inputs (g_a; the hyper decoder on JAX's ẑ; the
  synthesis of JAX's ŷ and syntax vector) within **3% of the stage's largest
  magnitude** (about 8 bf16 ulps at that magnitude), and the whole forward's
  bpp within **rtol 3%**. The entropy math runs in the model's dtype, as the
  JAX forward's does (it upcasts nothing there).
* **GDN widths** B2 does not take (C > 192; 16 < C with C % 4 ≠ 0): the
  gate ``b2_takes``, those widths against the JAX GDN, and the whole
  ``source_net`` at ``is_high`` (N = 384, M = 32) against JAX: z3, μ, σ
  and x_tilde atol/rtol 1e-4, symbols equal.
* **Window attention** at the U-Net hyper's shapes (ws 4 with head widths
  12 and 16, ws 2 with 64, 32 and 16) against the JAX module, atol/rtol
  1e-4, and the route gate: B5, B4 or the plain route, decided by the
  map's shape alone.
* **B3/B6 widths**: ``Conv2d.kernel_slot`` keeps a C_in that is no
  multiple of 4, and a grouped conv, out of both kernel slots.
* ``ChannelCoder`` rejects the non-decodable hypers with the JAX reason.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.layers.gdn import GDN as JGDN
from lic_tpu.layers.win_attention import WinBasedAttention as JWinBasedAttention
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.utils.amp import bf16_params
from lic_tpu_torch.config import CodecConfig
from lic_tpu_torch.layers import GDN, Conv2d, WinBasedAttention, WindowAttention
from lic_tpu_torch.layers.gdn import b2_takes
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.utils.params import params_from_flax, state_from_flax
from jax_params import init_params, wake

torch.set_num_threads(2)

ATOL = 1e-4
BF16_STAGE = 0.03  # of the stage's largest magnitude
BF16_BPP_RTOL = 0.03


def _nchw(a):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jinit(cfg):
    """The JAX model and its init, every all-zero leaf (biases, zero-init
    residual outputs) given small seeded values: at the init's zero biases
    the hyper decoder of an untrained model outputs exactly 0."""
    jm = JCodecModel(cfg)
    return jm, wake(init_params(jm), 7)


def _japply(jm, params, fn, *args):
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=fn))(params, *args)


# ------------------------------------------------------------------- bf16


def test_source_net_bf16_forward_matches_jax_bf16_params():
    _bf16_forward_matches_jax("source_net")


def test_net_ga_bf16_forward_matches_jax_bf16_params():
    """Past the masked attentions (the WAM gates' shifted windows, the
    SWAtten stacks): JAX casts the mask to the logits' dtype
    (``lic_tpu/layers/swin.py:120``, ``win_attention.py:252``), and so does
    the port, so both stay in bf16 there."""
    _bf16_forward_matches_jax("net_ga")


def _bf16_forward_matches_jax(preset):
    jm, params = _jinit(jget_config(preset, n_override=32))
    tm = build_model(preset, device="cpu", n_override=32)
    tm.load_state_dict(params_from_flax(params, tm.cfg))
    tm = tm.to(torch.bfloat16)
    pb = bf16_params(params)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)

    def close(stage, got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        tol = BF16_STAGE * np.abs(want).max()
        np.testing.assert_allclose(_nhwc(got), want, atol=tol, rtol=0, err_msg=stage)

    z3j = _japply(jm, pb, JCodecModel.analyze, xj)
    with torch.no_grad():
        z3t = tm.analyze(xt)
        assert z3t.dtype == torch.bfloat16
        close("g_a", z3t, z3j)
        med = np.asarray(jm.apply({"params": pb}, method=JCodecModel.eb_medians))
        zj = _japply(jm, pb, JCodecModel.hyper_encode, z3j)
        z_hat = jnp.round(zj - med) + med
        sj, mj = _japply(jm, pb, JCodecModel.hyper_decode, z_hat)
        st, mt = tm.hyper_decode(_nchw(np.asarray(z_hat.astype(jnp.float32))).bfloat16())
        close("scales", st, sj)
        close("means", mt, mj)
        oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(pb, xj)
        synj = _japply(jm, pb, JCodecModel.syntax_from_latent, z3j)
        recj = _japply(jm, pb, JCodecModel.synthesize, oj.extras["y_hat"], synj)
        rect = tm.synthesize(_nchw(np.asarray(oj.extras["y_hat"].astype(jnp.float32))).bfloat16(),
                             torch.from_numpy(np.array(synj.astype(jnp.float32)))
                             .permute(0, 3, 1, 2).bfloat16())
        close("synthesis", rect, recj)
        ot = tm(xt)
    assert ot.x_tilde.dtype == torch.bfloat16 and torch.isfinite(ot.x_tilde).all()
    np.testing.assert_allclose(float(ot.bpp), float(oj.bpp), rtol=BF16_BPP_RTOL)


# ------------------------------------------------------------- GDN widths


def test_b2_gate():
    assert [c for c in (8, 16, 17, 18, 20, 96, 100, 190, 192, 196, 384) if b2_takes(c)] == [
        8, 16, 20, 96, 100, 192]


@pytest.mark.parametrize("c", [18, 196, 384])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_widths_b2_does_not_take_match_jax(c, inverse):
    x = np.random.default_rng(c).standard_normal((2, 4, 6, c)).astype(np.float32)
    jmod = JGDN(c, inverse=inverse)
    params = jax.tree.map(np.array, jmod.init(jax.random.PRNGKey(c), jnp.asarray(x))["params"])
    params["gamma"] = params["gamma"] + 0.01 * np.random.default_rng(1).random((c, c), np.float32)
    tmod = GDN(c, inverse)
    tmod.load_state_dict(state_from_flax(params, tmod))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_source_net_is_high_matches_jax():
    cfg = jget_config("source_net", is_high=True)
    jm, params = _jinit(cfg)
    tm = build_model("source_net", device="cpu", is_high=True)
    assert (tm.cfg.N, tm.cfg.M) == (384, 32)
    tm.load_state_dict(params_from_flax(params))
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(params, jnp.asarray(x))
    z3j = np.asarray(_japply(jm, params, JCodecModel.analyze, jnp.asarray(x)))
    with torch.no_grad():
        ot = tm(_nchw(x))
        z3t = _nhwc(tm.analyze(_nchw(x)))
    np.testing.assert_allclose(z3t, z3j, atol=ATOL, rtol=ATOL)
    mu_t, mu_j = _nhwc(ot.extras["means"]), np.asarray(oj.extras["means"])
    np.testing.assert_allclose(mu_t, mu_j, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_nhwc(ot.extras["scales"]), np.asarray(oj.extras["scales"]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(np.round(z3t - mu_t), np.round(z3j - mu_j))
    np.testing.assert_allclose(_nhwc(ot.x_tilde), np.asarray(oj.x_tilde), atol=ATOL, rtol=ATOL)


# ------------------------------------------------------ window attention


@pytest.mark.parametrize("c,ws,shift,h,w", [
    (96, 4, 2, 8, 12),    # U-Net attn0: hd 12
    (128, 4, 2, 6, 10),   # attn1: hd 16, padded to the window grid
    (512, 2, 1, 4, 6),    # mid_attn: hd 64
    (256, 2, 1, 4, 6),    # attn3: hd 32
    (128, 2, 1, 3, 5),    # attn2: hd 16, padded
])
def test_win_based_attention_at_unet_head_widths_matches_jax(c, ws, shift, h, w):
    x = np.random.default_rng(c + ws).standard_normal((1, h, w, c)).astype(np.float32)
    jmod = JWinBasedAttention(c, 8, ws, shift)
    params = jax.tree.map(np.array, jmod.init(jax.random.PRNGKey(c), jnp.asarray(x))["params"])
    rng = np.random.default_rng(0)
    params["attn"]["proj"]["kernel"] = (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32)
    tmod = WinBasedAttention(c, 8, ws, shift)
    tmod.load_state_dict(state_from_flax(params, tmod))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("c,ws,hp,wp,fuse,want", [
    (192, 8, 128, 192, False, "wba"),       # B4 at hd 24
    (192, 4, 32, 48, True, "wba_proj"),     # B5 at (192, 24)
    (64, 4, 8, 12, False, "wba"),           # the WAM syntax gate: B4 at hd 8
    (64, 4, 8, 12, True, "wba"),            # B5 lacks (64, 8): B4 + Linear
    (64, 4, 64, 64, True, "wba_proj"),      # ... at 4096 tokens: B5 raises
    (96, 4, 32, 48, False, "plain"),        # hd 12 under 4096 tokens
    (96, 4, 32, 48, True, "plain"),
    (512, 2, 8, 12, False, "plain"),        # hd 64
    (384, 8, 64, 64, False, "wba"),         # hd 48 at 4096 tokens: B4
    (384, 8, 56, 64, False, "wba"),         # hd 48 under 4096 tokens: B4 too
    (384, 8, 64, 64, True, "wba_proj"),     # hd 48 at 4096 tokens: B5 at (384, 48)
    (384, 8, 56, 64, True, "wba_proj"),
])
def test_window_attention_route_gate(c, ws, hp, wp, fuse, want):
    m = WindowAttention(c, ws, 8, fuse_proj=fuse)
    assert m.route(torch.empty(2, hp, wp, c)) == want


# ------------------------------------------------------------ B3/B6 widths


@pytest.mark.parametrize("k,stride,pad,cin,want", [
    (5, 2, (1, 2, 1, 2), 132, "conv5s2"),
    (5, 2, (1, 2, 1, 2), 130, None),
    (5, 2, (1, 2, 1, 2), 385, None),
    (3, 1, 1, 188, "convk_s1"),
    (3, 1, 1, 190, None),
    (7, 1, 3, 129, None),
])
def test_conv_kernel_slot_needs_cin_multiple_of_4(k, stride, pad, cin, want):
    x = torch.randn(1, cin, 8, 12, generator=torch.Generator().manual_seed(cin))
    m = Conv2d(cin, 16, k, stride, pad)
    assert m.kernel_slot(x) == want
    xp = torch.nn.functional.pad(x, pad) if isinstance(pad, tuple) else x
    with torch.no_grad():
        ref = torch.nn.functional.conv2d(xp, m.weight, m.bias, stride,
                                         0 if isinstance(pad, tuple) else pad)
        torch.testing.assert_close(m(x), ref, atol=1e-5, rtol=1e-5)


def test_grouped_conv_takes_no_kernel_slot():
    m = Conv2d(160, 160, 3, 1, 1, groups=160)
    assert tuple(m.weight.shape) == (160, 1, 3, 3)
    assert m.kernel_slot(torch.zeros(1, 160, 4, 4)) is None


@pytest.mark.parametrize("hyper", ["unet", "latent_unet"])
def test_channel_coder_rejects_non_decodable_hypers(hyper):
    model = types.SimpleNamespace(cfg=CodecConfig(hyper=hyper))
    with pytest.raises(ValueError, match=f"hyper path '{hyper}' is not decodable"):
        ChannelCoder(model)
