"""Port parity: window attention (kernels B4/B5's plain versions), the
``WinNoShiftAttention`` gate and the whole ``source_net_wam`` codec, against
the JAX package on the CPU.

* ``wba_plain`` / ``wba_proj_plain`` against ``window_attention_fused`` /
  ``window_attention_fused_proj`` (``interpret=True``) and
  ``_wba_reference``, at ws 4 and 8, with and without shift and pad:
  atol/rtol 1e-5; plus the per-head no-underflow case;
* ``WinNoShiftAttention`` at C = 192, B = 1, 16×16: atol 1e-4;
* ``source_net_wam`` at ``n_override=32``, 128×128: z3 / μ / σ atol 1e-4,
  the integer symbols equal, and the port's codec roundtrip equal to its
  own eval forward within 1e-4.

Weights come from the JAX init, carried over by ``params_from_flax``; the
zero-init leaves (the attention's ``proj``, each ``ResidualBlock``'s second
conv) get small random values first, or they would hide the attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.layers.pallas_attn import (
    _wba_proj_reference,
    _wba_reference,
    flatten_mask,
    window_attention_fused,
    window_attention_fused_proj,
)
from lic_tpu.layers.win_attention import WinNoShiftAttention as JWinNoShift
from lic_tpu.layers.win_attention import swin_shift_mask as jswin_shift_mask
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.layers import WinNoShiftAttention, wba_plain, wba_proj_plain
from lic_tpu_torch.layers.window_attn import swin_shift_mask
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.utils.params import params_from_flax, state_from_flax

torch.set_num_threads(2)

TOL = 1e-5
ATOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _wake_zero_leaves(tree, seed):
    """Small random values for the zero-init kernels under the WAM gates."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        keys = "/".join(str(getattr(p, "key", p)) for p in path)
        if "wam" in keys and keys.endswith("kernel") and not np.any(leaf):
            return (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
        return np.array(leaf)

    return jax.tree_util.tree_map_with_path(f, tree)


def _attn_inputs(seed, b, hp, wp, c, nh, ws, shift, pad):
    rng = np.random.default_rng(seed)
    n = ws * ws
    rel_flat = rng.standard_normal((n, nh * n)).astype(np.float32)
    mask = None
    if shift or pad:
        mask = swin_shift_mask(hp - pad, wp - pad, ws, shift, pad, pad)
        np.testing.assert_array_equal(
            mask, jswin_shift_mask(hp - pad, wp - pad, ws, shift, pad, pad)
        )
    # the port's bias layout: rel[h, i, m] = rel_flat[i, h·n + m]
    rel = torch.from_numpy(np.ascontiguousarray(rel_flat.reshape(n, nh, n).transpose(1, 0, 2)))
    jmask = None if mask is None else flatten_mask(mask, hp // ws, wp // ws, nh)
    return rng, jnp.asarray(rel_flat), rel, jmask, None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("ws,hp,wp", [(8, 16, 24), (4, 8, 12)])
@pytest.mark.parametrize("shift,pad", [(0, 0), (0, 3), (2, 0), (2, 3)])
def test_wba_plain_matches_pallas_and_reference(ws, hp, wp, shift, pad):
    b, c, nh = 1, 192, 8
    rng, rel_j, rel_t, mask_j, mask_t = _attn_inputs(ws + 10 * shift + pad, b, hp, wp, c,
                                                     nh, ws, shift, pad)
    qkv = rng.standard_normal((b, hp, wp, 3 * c)).astype(np.float32)
    got = wba_plain(torch.from_numpy(qkv), rel_t, mask_t, ws, nh).numpy()
    pal = window_attention_fused(jnp.asarray(qkv), rel_j, mask_j, ws=ws, nh=nh,
                                 interpret=True)
    ref = _wba_reference(jnp.asarray(qkv), rel_j, mask_j, ws=ws, nh=nh)
    np.testing.assert_allclose(got, np.asarray(pal), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL)

    x = rng.standard_normal((b, hp, wp, c)).astype(np.float32)
    wqkv = (rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32)
    wproj = (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32)
    bqkv = rng.standard_normal(3 * c).astype(np.float32)
    bproj = rng.standard_normal(c).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = wba_proj_plain(t(x), rel_t, t(wqkv.T), t(bqkv), t(wproj.T), t(bproj),
                         mask_t, ws, nh).numpy()
    jargs = [jnp.asarray(a) for a in (x, rel_j, wqkv, bqkv, wproj, bproj)]
    pal = window_attention_fused_proj(*jargs, mask_j, ws=ws, nh=nh, interpret=True)
    ref = _wba_proj_reference(*jargs, mask_j, ws=ws, nh=nh)
    np.testing.assert_allclose(got, np.asarray(pal), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL)


def test_wba_plain_per_head_softmax_no_underflow():
    """Port copy of ``tests/test_pallas.py::test_per_head_softmax_shift_no_underflow``:
    head 0 dominates by ~200 nats; the other heads must not go 0/0."""
    b, hp, wp, c, nh, ws = 1, 8, 8, 16, 4, 8
    n = ws * ws
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b, hp, wp, 3 * c)).astype(np.float32)
    rel_flat = np.zeros((n, nh * n), np.float32)
    rel_flat[:, :n] = 200.0
    rel = torch.from_numpy(np.ascontiguousarray(rel_flat.reshape(n, nh, n).transpose(1, 0, 2)))
    got = wba_plain(torch.from_numpy(qkv), rel, None, ws, nh).numpy()
    assert np.isfinite(got).all()
    pal = window_attention_fused(jnp.asarray(qkv), jnp.asarray(rel_flat), None,
                                 ws=ws, nh=nh, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ws,shift", [(8, 4), (4, 2)])
def test_win_noshift_attention_matches(ws, shift):
    c = 192
    x = np.random.default_rng(ws).standard_normal((1, 16, 16, c)).astype(np.float32)
    jm = JWinNoShift(c, 8, ws, shift)
    params = _wake_zero_leaves(
        {"wam": jm.init(jax.random.PRNGKey(ws), jnp.asarray(x))["params"]}, ws
    )["wam"]
    ref = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x)))
    tm = WinNoShiftAttention(c, 8, ws, shift)
    tm.load_state_dict(state_from_flax(params, tm))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x).contiguous(memory_format=torch.channels_last)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.fixture(scope="module")
def wam_pair():
    jm = JCodecModel(jget_config("source_net_wam", n_override=32))
    init = jax.jit(
        lambda k: jm.init(
            {"params": k, "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, 64, 64, 3)), training=True,
        )
    )
    params = _wake_zero_leaves(init(jax.random.PRNGKey(0))["params"], 7)
    tm = build_model("source_net_wam", device="cpu", n_override=32)
    tm.load_state_dict(params_from_flax(params, PRESETS["source_net_wam"]))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    return jm, params, tm, x


def test_source_net_wam_forward_and_codec_match(wam_pair):
    jm, params, tm, x = wam_pair
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(
        params, jnp.asarray(x)
    )
    z3j = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, method=JCodecModel.analyze))(
        params, jnp.asarray(x)
    ))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ot = tm(xt)
        z3t = _nhwc(tm.analyze(xt))
    np.testing.assert_allclose(z3t, z3j, atol=ATOL, rtol=ATOL)
    mu_t, mu_j = _nhwc(ot.extras["means"]), np.asarray(oj.extras["means"])
    np.testing.assert_allclose(mu_t, mu_j, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_nhwc(ot.extras["scales"]), np.asarray(oj.extras["scales"]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(np.round(z3t - mu_t), np.round(z3j - mu_j))
    np.testing.assert_allclose(_nhwc(ot.x_tilde), np.asarray(oj.x_tilde), atol=ATOL, rtol=ATOL)

    coder = ChannelCoder(tm, name="source_net_wam")
    rec = coder.decompress_batch(coder.compress_batch(xt))
    torch.testing.assert_close(rec, ot.x_tilde, atol=ATOL, rtol=0)
