"""Port parity: the ``source_net`` slice modules, the whole eval forward,
and the port's real-bitstream codec, on the CPU.

``source_net`` with ``n_override=32`` at 128×128, weights from the JAX
package's own init (random: the repository has no trained checkpoint),
carried over by ``params_from_flax``.  Tolerances:

* slice modules and z3 / μ / σ: atol 1e-4 (fp32 sums in another order);
* the integer symbols round(y − μ) agree at >= 99.9% of positions (a .5
  tie can flip under another summation order);
* x_tilde at atol 1e-4 where every symbol agrees, and the port's
  synthesis of the JAX y_hat at atol 1e-4 always; bpp at rtol 1e-3;
* the codec's reconstruction equals the port's own eval forward within
  atol 1e-4 (``tests/test_compress.py:483-491`` asserts the same for JAX).
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.coding import codec as jcodec
from lic_tpu.coding.device_rans import Rans16InterleavedCodec
from lic_tpu_torch import coding as tcoding
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.utils.params import params_from_flax

torch.set_num_threads(2)

ATOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    cfg = jget_config("source_net", n_override=32)
    jm = JCodecModel(cfg)
    init = jax.jit(
        lambda k: jm.init(
            {"params": k, "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, 64, 64, 3)), training=True,
        )
    )
    params = jax.tree.map(np.array, init(jax.random.PRNGKey(0))["params"])
    tm = build_model("source_net", device="cpu", n_override=32)
    tm.load_state_dict(params_from_flax(params))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    return jm, params, tm, x


def _japply(jm, params, fn, *args):
    return jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, method=fn)
    )(params, *args)


def test_slice_modules_match(pair):
    """g_a, the hyper pair, g_s, the syntax model and generator, and every
    slice stack, each on the same input; atol 1e-4."""
    jm, params, tm, x = pair
    rng = np.random.default_rng(4)
    n = 32
    z3 = rng.standard_normal((2, 8, 8, n)).astype(np.float32)
    zh = np.round(rng.standard_normal((2, 2, 2, n)) * 2).astype(np.float32)
    sup = rng.standard_normal((2, 8, 8, n + 24)).astype(np.float32)
    syn = np.round(rng.standard_normal((2, 1, 1, 16)) * 3).astype(np.float32)
    cases = [
        (lambda m, a: m.g_a(a), tm.g_a, x),
        (lambda m, a: m.h_a(a), tm.h_a, z3),
        (lambda m, a: m.h_mean_s(a), tm.h_mean_s, zh),
        (lambda m, a: m.h_scale_s(a), tm.h_scale_s, zh),
        (lambda m, a: m.g_s(a), tm.g_s, z3),
        (lambda m, a: m.syntax_model(a), tm.syntax_model, z3[..., :16]),
        (lambda m, a: m.cc_mean_transforms[3](a), tm.cc_mean_transforms[3], sup),
        (lambda m, a: m.cc_scale_transforms[3](a), tm.cc_scale_transforms[3], sup),
        (lambda m, a: m.lrp_transforms[2](a), tm.lrp_transforms[2], sup),
    ]
    with torch.no_grad():
        for fj, mod, a in cases:
            yj = np.asarray(_japply(jm, params, fj, jnp.asarray(a)))
            yt = _nhwc(mod(_nchw(a).contiguous(memory_format=torch.channels_last)))
            np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=ATOL)
        wj = np.asarray(
            _japply(jm, params, lambda m, a: m.conv_weights_gen(a), jnp.asarray(syn))
        )
        wt = tm.conv_weights_gen(_nchw(syn))
        np.testing.assert_allclose(wt.numpy(), wj, atol=ATOL, rtol=ATOL)


def test_eval_forward_matches(pair):
    jm, params, tm, x = pair
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(
        params, jnp.asarray(x)
    )
    z3j = np.asarray(_japply(jm, params, JCodecModel.analyze, jnp.asarray(x)))
    with torch.no_grad():
        xt = _nchw(x)
        ot = tm(xt)
        z3t = _nhwc(tm.analyze(xt))
    np.testing.assert_allclose(z3t, z3j, atol=ATOL, rtol=ATOL)
    mu_t, mu_j = _nhwc(ot.extras["means"]), np.asarray(oj.extras["means"])
    np.testing.assert_allclose(mu_t, mu_j, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        _nhwc(ot.extras["scales"]), np.asarray(oj.extras["scales"]),
        atol=ATOL, rtol=ATOL,
    )
    sym_j, sym_t = np.round(z3j - mu_j), np.round(z3t - mu_t)
    n_diff = int((sym_j != sym_t).sum())
    agree = 1.0 - n_diff / sym_j.size
    assert agree >= 0.999, f"{n_diff} of {sym_j.size} symbols differ"
    if n_diff == 0:
        np.testing.assert_allclose(
            _nhwc(ot.x_tilde), np.asarray(oj.x_tilde), atol=ATOL, rtol=ATOL
        )
    np.testing.assert_allclose(float(ot.bpp), float(oj.bpp), rtol=1e-3)
    np.testing.assert_allclose(float(ot.bpp_z), float(oj.bpp_z), rtol=1e-3)
    # synthesis of the JAX latent: independent of any flipped symbol
    syn = np.asarray(_japply(jm, params, JCodecModel.syntax_from_latent, jnp.asarray(z3j)))
    rec_j = _japply(jm, params, JCodecModel.synthesize, oj.extras["y_hat"], jnp.asarray(syn))
    with torch.no_grad():
        rec_t = tm.synthesize(
            _nchw(oj.extras["y_hat"]).contiguous(memory_format=torch.channels_last),
            _nchw(syn),
        )
    np.testing.assert_allclose(_nhwc(rec_t), np.asarray(rec_j), atol=ATOL, rtol=ATOL)
    print(f"symbols agreeing: {sym_j.size - n_diff}/{sym_j.size}")


@pytest.fixture(scope="module")
def coder(pair):
    return ChannelCoder(pair[2], name="source_net")


def test_codec_batch_roundtrip_matches_forward(pair, coder):
    _, _, tm, x = pair
    xt = _nchw(x)
    blobs = coder.compress_batch(xt)  # raises if the final-state check fails
    rec = coder.decompress_batch(blobs)
    with torch.no_grad():
        ref = tm(xt).x_tilde
    assert rec.shape == ref.shape
    torch.testing.assert_close(rec, ref, atol=ATOL, rtol=0)


def test_codec_single_image_matches_batch(pair, coder):
    """The per-image path writes the batch path's bytes and decodes to its
    reconstruction (``tests/test_compress.py:182-198``).  Cross-batch
    decode compares σ-indexes computed at B=1 and B=2: the CPU gives the
    same bits at both."""
    _, _, tm, x = pair
    xt = _nchw(x)
    blobs = coder.compress_batch(xt)
    for i in range(xt.shape[0]):
        assert coder.compress(xt[i : i + 1]) == blobs[i], f"stream {i} differs"
    rec = coder.decompress_batch(blobs)
    rec0 = coder.decompress(blobs[0])
    torch.testing.assert_close(rec[:1], rec0, atol=ATOL, rtol=0)
    with torch.no_grad():
        ref = tm(xt[:1]).x_tilde
    torch.testing.assert_close(rec0, ref, atol=ATOL, rtol=0)


def test_codec_arbitrary_size(pair, coder):
    """Non-/64 sizes: padded inside compress, cropped by decompress."""
    _, _, tm, _ = pair
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 100, 90)).astype(np.float32))
    rec = coder.decompress(coder.compress(x))
    assert rec.shape == (1, 3, 100, 90)
    from lic_tpu_torch.data import pad_to_multiple

    with torch.no_grad():
        ref = tm(pad_to_multiple(x, 64)[0]).x_tilde[:, :, :100, :90]
    torch.testing.assert_close(rec, ref, atol=ATOL, rtol=0)


def test_codec_rejects_truncation_and_foreign_streams(pair, coder):
    _, _, tm, x = pair
    blob = coder.compress(_nchw(x[:1]))
    with pytest.raises(ValueError, match="corrupt or truncated"):
        coder.decompress(blob[: len(blob) - 40])
    with pytest.raises(ValueError, match="magic"):
        coder.decompress(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="source_net"):
        ChannelCoder(tm, name="other").decompress(blob)


def _split(coder, blob):
    off, h, w, syntax = coder._parse_header(blob)
    (z_len,) = struct.unpack_from("<I", blob, off)
    off += 4 + z_len
    (y_len,) = struct.unpack_from("<I", blob, off)
    return blob[off + 4 : off + 4 + y_len]


def test_jax_reads_port_stream(pair, coder):
    """The JAX ChannelCoder's header parser reads the port's header, and
    the host C++ decoder reads the port's y stream back to the port's
    symbols given the port's CDF rows."""
    jm, params, tm, x = pair
    xt = _nchw(x[:1])
    blob = coder.compress(xt)
    jcoder = JChannelCoder(jm, params, name="source_net")
    assert jcoder.digest == coder.digest
    off_j, h_j, w_j, syn_j = jcoder._parse_header(blob)
    off_t, h_t, w_t, syn_t = coder._parse_header(blob)
    assert (off_j, h_j, w_j) == (off_t, h_t, w_t) == (off_t, 128, 128)
    np.testing.assert_array_equal(syn_j, syn_t)

    with torch.no_grad():
        z3 = tm.analyze(xt)
        _, z_hat = coder._z_enc(z3, 1)
        sym, rows, _, _ = coder._slices_pass(z_hat, 1, y=z3)
    counts = coder._step_counts(z3.shape[2], z3.shape[3])
    dec = Rans16InterleavedCodec(
        coder.y_coder.codec.cdfs, coder.y_coder.codec.offsets
    ).decode_host(_split(coder, blob), rows[0].numpy().astype(np.int32), counts)
    np.testing.assert_array_equal(dec, sym[0].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_coders_write_the_jax_bytes(seed):
    """The port's copies of the host coders (``coding.host_rans`` on its own
    ``csrc/rans.cpp``) write byte-identical streams to the JAX package's for
    the same symbols, escapes included, and decode them back."""
    rng = np.random.default_rng(seed)
    tg, jg = tcoding.GaussianCoder(), jcodec.GaussianCoder()
    np.testing.assert_array_equal(tg.codec.cdfs, jg.codec.cdfs)
    np.testing.assert_array_equal(tg.scale_table, jg.scale_table)
    n = 3000
    rows = rng.integers(0, 64, n).astype(np.int32)
    sym = rng.integers(-20, 21, n).astype(np.int32)
    pos = rng.choice(n, 40, replace=False)
    sym[pos] = rng.integers(-5000, 5000, 40)  # escapes
    sym[pos[0]] = (1 << 30) + 7
    assert tg.codec.encode(sym, rows) == jg.codec.encode(sym, rows)
    steps = [1000, 1000, 1000]
    t_lane = tcoding.Rans16InterleavedCodec(tg.codec.cdfs, tg.codec.offsets)
    j_lane = Rans16InterleavedCodec(jg.codec.cdfs, jg.codec.offsets)
    blob = t_lane.encode(sym, rows, steps, 128)
    assert blob == j_lane.encode(sym, rows, steps, 128)
    np.testing.assert_array_equal(t_lane.decode_host(blob, rows, steps), sym)

    pmf = rng.dirichlet(np.ones(64), size=8) * 0.98
    med = rng.standard_normal(8).astype(np.float32)
    tf, jf = tcoding.FactorizedCoder(pmf, med, -32), jcodec.FactorizedCoder(pmf, med, -32)
    z = rng.integers(-40, 40, (1, 3, 5, 8)).astype(np.int32)
    zb = tf.encode_symbols(z)
    assert zb == jf.encode_symbols(z)
    np.testing.assert_array_equal(tf.decode_symbols(zb, z.shape), z)
