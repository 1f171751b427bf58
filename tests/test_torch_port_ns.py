"""Port parity: the neural-syntax codec (``neural_syntax``) and its
wavefront coder against the JAX package, on the CPU.

* exact: ``block_sample`` / ``neighbor_sample``, ``wavefront_groups``,
  the lane count, the ``GaussianMuCoder`` table, its rows and its host
  streams, the z2 stream of ``GaussianCoder.encode_symbols``;
* the drain's plain version (kernel B1's reference) bit-exact against the
  JAX ``decode_chunk`` scan on the 1,024-row ``GaussianMuCoder`` table at
  L = 8, 32 and 256, stress streams (1 symbol in 17 escaping) included;
* ``PredictionModelContext`` (masked and not) and ``PredictionModelSyntax``
  on seeded inputs within 1e-4, JAX parameters carried over;
* the preset's row equals the JAX package's; the eval forward at
  ``n_override=32``, 128×128 within 1e-4 (bpp rtol 1e-4); the training
  forward (B 2, 64×64) with JAX's three noise draws (z2, content, syntax)
  replayed, and its gradients within 1e-4 of each leaf's range;
* the coder: the wavefront loop's residuals and rows equal to the JAX
  scan's, ``.ltc`` streams byte for byte both ways and each decoded by the
  other package within 1e-4 of its forward; ``.npz`` weights both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.coding.codec import GaussianCoder as JGaussianCoder
from lic_tpu.coding.codec import GaussianMuCoder as JGaussianMuCoder
from lic_tpu.coding.device_rans import DeviceRans16Interleaved as JDev
from lic_tpu.entropy import context as jctx
from lic_tpu.models import compress as jcompress
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import PRESETS as JPRESETS, get_config as jget_config
from lic_tpu.models.syntax import PredictionModelSyntax as JPredictionModelSyntax
from lic_tpu.utils import checkpoint as jckpt
from lic_tpu_torch.coding import (
    DeviceRans16Interleaved,
    GaussianCoder,
    GaussianMuCoder,
    drain_plain,
    load_host_rans,
    random_streams,
)
from lic_tpu_torch.data.pad import pad_to_multiple
from lic_tpu_torch.entropy import context as tctx
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models import compress as tcompress
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.models.syntax import PredictionModelSyntax
from lic_tpu_torch.utils.checkpoint import load_params, save_params
from lic_tpu_torch.utils.params import flax_leaves, params_from_flax, state_from_flax, to_flax_layout

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


def _wake(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.array(a) if np.any(a)
        else (rng.standard_normal(a.shape) * 0.05).astype(np.float32), tree)


@pytest.fixture(scope="module")
def ns():
    jm = JCodecModel(jget_config("neural_syntax", n_override=N))
    init = jax.jit(lambda k: jm.init(
        {"params": k, "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, 64, 3)),
        training=True))
    params = _wake(init(jax.random.PRNGKey(0))["params"], 7)
    # a z2 σ per channel, not all ones: the digest and the z2 rows see it
    params["z2_sigma"] = np.random.default_rng(3).uniform(
        0.3, 3.0, params["z2_sigma"].shape).astype(np.float32)
    tm = build_model("neural_syntax", device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params, PRESETS["neural_syntax"]))
    return jm, params, tm


# ------------------------------------------------------------ exact parts


def test_preset_equals_jax_row():
    assert dataclasses.asdict(PRESETS["neural_syntax"]) == dataclasses.asdict(
        JPRESETS["neural_syntax"])


@pytest.mark.parametrize("masked", [True, False])
def test_block_and_neighbor_sample_equal_jax(masked):
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tctx.block_sample(_nchw(x), masked).permute(0, 2, 3, 1).numpy(),
        np.asarray(jctx.block_sample(jnp.asarray(x), masked)))
    np.testing.assert_array_equal(
        tctx.neighbor_sample(_nchw(x)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jctx.neighbor_sample(jnp.asarray(x))))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (4, 4), (8, 12), (32, 48)])
def test_wavefront_schedule_and_lanes_equal_jax(h, w):
    for (tp, tq), (jp, jq) in zip(tcompress.wavefront_groups(h, w),
                                  jcompress.wavefront_groups(h, w), strict=True):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tq, jq)
    for total in (h * w * 16, h * w * 176, 1, 10 ** 6):
        assert tcompress.ns_lane_count(total) == JChannelCoder._ns_lane_count(total)


def test_mu_coder_tables_rows_and_streams_equal_jax():
    load_host_rans()
    t, j = GaussianMuCoder(), JGaussianMuCoder()
    np.testing.assert_array_equal(t.codec.cdfs, j.codec.cdfs)
    assert t.codec.cdfs.shape == (1024, 131)
    rng = np.random.default_rng(2)
    mu = (rng.standard_normal(300) * 5).astype(np.float32)
    sg = np.exp(rng.uniform(-3, 6, 300)).astype(np.float32)
    y = np.round(mu + rng.standard_normal(300) * sg).astype(np.int32)
    np.testing.assert_array_equal(t.indexes(sg, mu), j.indexes(sg, mu))
    blob = t.encode_ints(y, mu, sg)
    assert blob == j.encode_ints(y, mu, sg)
    np.testing.assert_array_equal(t.decode_ints(blob, mu, sg), y)
    sym = rng.integers(-20, 20, (3, 4, 8)).astype(np.int32)
    scales = np.broadcast_to(np.exp(rng.uniform(-2, 3, 8)), (3, 4, 8))
    assert GaussianCoder().encode_symbols(sym, scales) == JGaussianCoder().encode_symbols(
        sym, scales)


def _jax_scan(dev, lanes, pay, rows, s_tot, n_lanes):
    b, s = rows.shape
    mc = -(-s // n_lanes)
    rows_pad = np.zeros((b, mc * n_lanes), np.int32)
    rows_pad[:, :s] = rows
    rows_sc = jnp.asarray(rows_pad.reshape(b, mc, n_lanes).transpose(1, 0, 2))
    valid_sc = jnp.asarray((np.arange(mc)[:, None] * n_lanes + np.arange(n_lanes)) < s_tot)

    def chunk(lanes, xs):
        rk, vd = xs
        vals, lanes = dev.decode_chunk(lanes, pay, rk, jnp.broadcast_to(vd, (b, n_lanes)))
        return lanes, vals

    lanes, dec = jax.lax.scan(chunk, lanes, (rows_sc, valid_sc))
    return lanes, np.asarray(dec).transpose(1, 0, 2).reshape(b, -1)[:, :s]


@pytest.mark.parametrize("n_lanes", [8, 32, 256])
def test_drain_plain_bitexact_vs_jax_scan_on_the_mu_table(n_lanes):
    """Two calls threading the state (a 24·16-symbol wavefront, then 37),
    one stress stream and one plain, on the 1,024-row table."""
    load_host_rans()
    coder = GaussianMuCoder()
    cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
    steps = [384, 37]
    sym, idx, pay, ends = random_streams(
        cdfs, offsets, [(60 + n_lanes, True), (70 + n_lanes, False)], steps, n_lanes)
    dev = DeviceRans16Interleaved(cdfs, offsets, n_lanes, device="cpu")
    jdev = JDev(cdfs, offsets, n_lanes)
    payt, jpay = torch.from_numpy(pay), jnp.asarray(pay)
    t_lanes, j_lanes, off = dev.init_lanes(payt), jdev.init_lanes(jpay), 0
    for m in steps:
        rows = idx[:, off : off + m]
        t_lanes, t_dec = drain_plain(dev, t_lanes, payt, torch.from_numpy(rows.copy()), m)
        j_lanes, j_dec = _jax_scan(jdev, j_lanes, jpay, rows, m, n_lanes)
        np.testing.assert_array_equal(t_dec.numpy(), j_dec)
        np.testing.assert_array_equal(t_lanes.state.numpy(),
                                      np.asarray(j_lanes.state).astype(np.int64))
        np.testing.assert_array_equal(t_lanes.ptr.numpy(), np.asarray(j_lanes.ptr))
        np.testing.assert_array_equal(t_dec.numpy(), sym[:, off : off + m])
        off += m
    np.testing.assert_array_equal(t_lanes.ptr.numpy(), ends)


# ------------------------------------------------------------ the modules


@pytest.mark.parametrize("masked", [True, False])
def test_prediction_model_context_matches(masked):
    rng = np.random.default_rng(4)
    y = np.round(rng.standard_normal((2, 4, 6, 12)) * 3).astype(np.float32)
    h = rng.standard_normal((2, 4, 6, 20)).astype(np.float32)
    jmod = jctx.PredictionModelContext(dim=20, outdim=24)
    params = _wake(jmod.init(jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(h),
                             masked)["params"], 2)
    tmod = tctx.PredictionModelContext(32, 20, 24)
    tmod.load_state_dict(state_from_flax(params, tmod))
    mu_j, s_j = jmod.apply({"params": params}, jnp.asarray(y), jnp.asarray(h), masked)
    with torch.no_grad():
        mu_t, s_t = tmod(_nchw(y), _nchw(h), masked)
    _close(_nhwc(mu_t), mu_j)
    _close(_nhwc(s_t), s_j)


@pytest.mark.parametrize("variant", ["basic", "wam"])
def test_prediction_model_syntax_matches(variant):
    h = np.random.default_rng(5).standard_normal((2, 16, 20, 24)).astype(np.float32)
    jmod = JPredictionModelSyntax(dim=16, outdim=32, variant=variant)
    params = _wake(jmod.init(jax.random.PRNGKey(3), jnp.asarray(h))["params"], 4)
    tmod = PredictionModelSyntax(24, 16, 32, variant)
    tmod.load_state_dict(state_from_flax(params, tmod))
    mu_j, s_j = jmod.apply({"params": params}, jnp.asarray(h))
    with torch.no_grad():
        mu_t, s_t = tmod(_nchw(h))
    _close(_nhwc(mu_t), mu_j)
    _close(_nhwc(s_t), s_j)


# ------------------------------------------------------------ the forwards


def test_eval_forward_matches(ns):
    jm, params, tm = ns
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(params, jnp.asarray(x))
    with torch.no_grad():
        ot = tm(_nchw(x))
    np.testing.assert_array_equal(_nhwc(ot.extras["y_hat"]), oj.extras["y_hat"])
    np.testing.assert_array_equal(_nhwc(ot.extras["syntax"]), oj.extras["syntax"])
    _close(_nhwc(ot.extras["content_mu"]), oj.extras["content_mu"])
    _close(_nhwc(ot.extras["content_sigma"]), oj.extras["content_sigma"])
    _close(_nhwc(ot.x_tilde), oj.x_tilde)
    for k in ("bpp", "bpp_y", "bpp_z", "bpp_syntax"):
        np.testing.assert_allclose(float(getattr(ot, k)), float(getattr(oj, k)), rtol=ATOL)
    assert float(tm.entropy_aux_loss()) == 0.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_training_forward_and_gradients_match(ns):
    """B 2 at 64×64: λ·255²·mse + bpp with JAX's three draws (z2, content,
    syntax, in that order) replayed; every gradient within 1e-4 of its
    leaf's range."""
    jm, params, tm = ns
    x = np.random.default_rng(12).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": jax.random.PRNGKey(5)})
        return 0.0025 * 255 ** 2 * out.mse + out.bpp, (out.bpp, out.mse)

    jax.random.uniform = recording
    try:
        (loss_j, (bpp_j, mse_j)), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
    assert [d.shape[-1] for d in draws] == [N, N - 16, 16]
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay).transpose(0, 3, 1, 2)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.array(a))

    tm.train()
    try:
        out = tm(_nchw(x), training=True, noise_fn=noise_fn)
        loss = 0.0025 * 255 ** 2 * out.mse + out.bpp + tm.entropy_aux_loss()
        tm.zero_grad()
        loss.backward()
    finally:
        tm.eval()
    np.testing.assert_allclose([loss.item(), out.bpp.item(), out.mse.item()],
                               [float(loss_j), float(bpp_j), float(mse_j)], rtol=1e-5)
    p = dict(tm.named_parameters())
    got = {k: to_flax_layout(m, n, p[s].grad) for s, k, m, n in flax_leaves(tm)}
    ref = _flat(grads_j)
    assert set(got) == set(ref)
    for k, r in ref.items():
        tol = max(1e-4 * float(np.abs(r).max()), 1e-7)
        assert float(np.abs(got[k] - r).max()) <= tol, k


# --------------------------------------------------------------- the coder


@pytest.fixture(scope="module")
def coders(ns):
    jm, params, tm = ns
    return JChannelCoder(jm, params, name="neural_syntax"), ChannelCoder(tm, name="neural_syntax")


def test_wavefront_residuals_and_rows_equal_jax(coders):
    """The encode-mode wavefront loop on the same integer latent and h2:
    every valid slot's residual and ``GaussianMuCoder`` row equal to the
    JAX scan's."""
    jc, tc = coders
    rng = np.random.default_rng(6)
    hy, wy = 4, 8  # the hyper decoder's ×4 of z2's 1×2
    z2 = rng.integers(-3, 4, (1, 1, 2, N)).astype(np.float32)
    y = rng.integers(-6, 7, (1, hy, wy, N - 16)).astype(np.int32)
    h2_j = jc._ns_hs(jnp.asarray(z2))
    fn, groups, n_lanes, _, _ = jc._ns_scan(hy, wy, batch=1)
    res_j, rows_j, _, _, _, _ = fn(h2_j, jnp.zeros((1, 2 * n_lanes), jnp.int32),
                                   jnp.asarray(y), jnp.int32(0))
    with torch.no_grad():
        h2_t = tc.model.ns_hyper_decode(_nchw(z2))
        res_t, rows_t, plane, _ = tc._wavefronts(h2_t, 1, y_known=_nchw(y).to(torch.int32))
    vt = np.concatenate([np.full(len(ps), t) for t, (ps, _) in enumerate(groups)])
    vp = np.concatenate([np.arange(len(ps)) for ps, _ in groups])
    np.testing.assert_array_equal(rows_t.numpy()[vt, :, vp], np.asarray(rows_j)[vt, :, vp])
    np.testing.assert_array_equal(res_t.numpy()[vt, :, vp], np.asarray(res_j)[vt, :, vp])
    np.testing.assert_array_equal(_nhwc(plane), y)


def test_ltc_streams_cross_both_ways(coders):
    jc, tc = coders
    x = np.random.default_rng(9).uniform(-1, 1, (2, 60, 100, 3)).astype(np.float32)
    jb = jc.compress_batch(jnp.asarray(x))
    tb = tc.compress_batch(_nchw(x))
    assert tb == jb
    assert tc.digest == jc.digest
    with torch.no_grad():
        ref = torch.cat([tc.model(t).x_tilde for t in pad_to_multiple(_nchw(x), 64)[0].split(1)])
    rec_t = tc.decompress_batch(jb)
    torch.testing.assert_close(rec_t, ref[:, :, :60, :100], atol=ATOL, rtol=0)
    _close(np.asarray(jc.decompress(tb[1])), _nhwc(rec_t[1:]))
    assert tc.compress(_nchw(x[1:])) == tb[1]
    bad = bytearray(tb[0])
    bad[-3] ^= 0x5A
    with pytest.raises(ValueError, match="final-state|corrupt"):
        tc.decompress(bytes(bad))


def test_npz_weights_both_ways(ns, tmp_path):
    """The port's ``.npz`` loads into the JAX package strictly and back,
    ``prediction_model_syntax`` and ``z2_sigma`` among the model's own."""
    jm, params, tm = ns
    save_params(str(tmp_path / "t.npz"), tm)
    back = jckpt.load_params(str(tmp_path / "t.npz"), params, strict=True)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)
    jckpt.save_params(str(tmp_path / "j.npz"), params)
    other = load_params(str(tmp_path / "j.npz"), build_model("neural_syntax", device="cpu",
                                                             n_override=N, seed=4))
    for (k, a), b in zip(tm.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
