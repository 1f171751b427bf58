"""Port parity: the entroformer checkerboard codecs (``entroformer_cb``,
``entroformer_cb_full``) against the JAX package, on the CPU.

* the blocks of ``layers/entroformer.py`` on seeded inputs, each with its
  JAX parameters carried over by ``state_from_flax`` (zero-init leaves
  woken): the relative-position buckets and the masks exactly; the
  attention (plain, top-k, masked, top-k and masked), the block,
  ``TransHyperScale`` down and up and ``EntroformerContext`` in both
  modes within 1e-4;
* the presets' rows equal the JAX package's;
* the eval forward of both presets at ``n_override=32``, 128×128: μ, σ,
  x_tilde within 1e-4, bpp rtol 1e-4, the symbols round(y − μ) equal;
* the training forward of ``entroformer_cb`` (B 2, 64×64) with JAX's two
  noise draws (z, y) replayed, and its gradients within 1e-4 of each
  leaf's range;
* the coder's rows and symbols (both checkerboard passes) equal to the
  JAX coder's, and ``.ltc`` streams byte for byte both ways, each decoded
  by the other package within 1e-4 of its forward.

The models' zero-init leaves are woken with seeded values, the entropy
bottleneck's ``factor_i`` included, as in a trained checkpoint: its
quantized CDF tables set the digest, so the ``.ltc`` streams cross only
where the port's pmf table is JAX's bit for bit (ROADMAP §C7, closed by
``entropy/xla_f32.py``).  ``test_woken_eb_cdf_tables_equal_jax`` holds
the tables equal for six more seeds of the EB's factors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.coding.codec import FactorizedCoder as JFactorizedCoder
from lic_tpu.layers import entroformer as jent
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import PRESETS as JPRESETS, get_config as jget_config
from lic_tpu_torch.coding.host_rans import FactorizedCoder
from lic_tpu_torch.data.pad import pad_to_multiple
from lic_tpu_torch.layers import entroformer as tent
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import Z_RANGE, ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.utils.params import flax_leaves, params_from_flax, state_from_flax, to_flax_layout

torch.set_num_threads(2)

ATOL = 1e-4
N = 32


def _nchw(a):
    t = torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=ATOL)


def _wake(tree, seed):
    """Small seeded values for every all-zero leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.array(a) if np.any(a)
        else (rng.standard_normal(a.shape) * 0.05).astype(np.float32), tree)


def _pair(name, seed=0):
    jm = JCodecModel(jget_config(name, n_override=N))
    init = jax.jit(lambda k: jm.init(
        {"params": k, "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, 64, 3)),
        training=True))
    params = _wake(init(jax.random.PRNGKey(seed))["params"], 7)
    tm = build_model(name, device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params, PRESETS[name]))
    return jm, params, tm


@pytest.fixture(scope="module")
def cb():
    return _pair("entroformer_cb")


def _module(jmod, tmod, *inputs, seed=0, **kw):
    """Init ``jmod`` on ``inputs``, wake its zero leaves, carry them into
    ``tmod``; → (JAX params, the flax apply)."""
    params = _wake(jmod.init(jax.random.PRNGKey(seed), *inputs, **kw)["params"], seed + 1)
    tmod.load_state_dict(state_from_flax(params, tmod))
    return params


# -------------------------------------------------------------- ops, exact


@pytest.mark.parametrize("q,k,nb", [((3, 5), (3, 5), 5), ((4, 4), (2, 6), 3), ((6, 2), (6, 2), 7)])
def test_buckets_and_masks_equal_jax(q, k, nb):
    np.testing.assert_array_equal(tent.relative_position_buckets(q, k, nb),
                                  jent.relative_position_buckets(q, k, nb))
    np.testing.assert_array_equal(tent.raster_causal_mask(*q), jent.raster_causal_mask(*q))
    for a, b in zip(tent.checkerboard_masks(*q), jent.checkerboard_masks(*q)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="odd"):
        tent.relative_position_buckets(q, k, 4)


def test_presets_equal_jax_rows():
    for name in ("entroformer_cb", "entroformer_cb_full"):
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(JPRESETS[name])


# ----------------------------------------------------------- the modules

CFG = dict(dim=48, num_layers=2, num_heads=4, dim_head=12)


@pytest.mark.parametrize("topk,masked", [(-1, False), (5, False), (-1, True), (7, True)])
def test_attention_matches(topk, masked):
    cfg = dict(CFG, attn_topk=topk)
    shape = (4, 6)
    x = np.random.default_rng(3).standard_normal((2, 24, 48)).astype(np.float32)
    mask = jent.raster_causal_mask(*shape) if masked else None
    jmod = jent.EntroformerAttention(jent.EntroformerConfig(**cfg))
    tmod = tent.EntroformerAttention(tent.EntroformerConfig(**cfg))
    params = _module(jmod, tmod, jnp.asarray(x), shape, mask, topk)
    want = jmod.apply({"params": params}, jnp.asarray(x), shape,
                      None if mask is None else jnp.asarray(mask), topk)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), shape,
                   None if mask is None else torch.from_numpy(mask), topk)
    _close(got.numpy(), want)


def test_block_matches():
    shape = (3, 5)
    x = np.random.default_rng(4).standard_normal((2, 15, 48)).astype(np.float32)
    jmod = jent.EntroformerBlock(jent.EntroformerConfig(**CFG))
    tmod = tent.EntroformerBlock(tent.EntroformerConfig(**CFG))
    params = _module(jmod, tmod, jnp.asarray(x), shape, seed=2)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), shape)
    _close(got.numpy(), jmod.apply({"params": params}, jnp.asarray(x), shape))


@pytest.mark.parametrize("down", [True, False])
def test_trans_hyper_scale_matches(down):
    """Down (space-to-depth merges, 8×12 → 2×3) and up (2×3 → 8×12),
    two scales, top-k on."""
    cfg = dict(CFG, attn_topk=6)
    hw = (8, 12) if down else (2, 3)
    x = np.random.default_rng(5).standard_normal((1, *hw, 20)).astype(np.float32)
    jmod = jent.TransHyperScale(20, 24, 2, down, jent.EntroformerConfig(**cfg))
    tmod = tent.TransHyperScale(20, 24, 2, down, tent.EntroformerConfig(**cfg))
    params = _module(jmod, tmod, jnp.asarray(x), seed=4)
    with torch.no_grad():
        got = tmod(_nchw(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    assert got.shape[2:] == tuple(want.shape[1:3])
    _close(_nhwc(got), want)


@pytest.mark.parametrize("mode", ["checkerboard", "raster"])
def test_context_matches(mode):
    rng = np.random.default_rng(6)
    y = np.round(rng.standard_normal((2, 4, 6, 10)) * 2).astype(np.float32)
    hyper = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    jmod = jent.EntroformerContext(10, mode, jent.EntroformerConfig(**CFG))
    tmod = tent.EntroformerContext(10, 16, mode, tent.EntroformerConfig(**CFG))
    params = _module(jmod, tmod, jnp.asarray(y), jnp.asarray(hyper), seed=6)
    mu_j, s_j = jmod.apply({"params": params}, jnp.asarray(y), jnp.asarray(hyper))
    with torch.no_grad():
        mu_t, s_t = tmod(_nchw(y), _nchw(hyper))
    _close(_nhwc(mu_t), mu_j)
    _close(_nhwc(s_t), s_j)


# ---------------------------------------------------------- the forwards


@pytest.mark.parametrize("name", ["entroformer_cb", "entroformer_cb_full"])
def test_eval_forward_matches(name, cb):
    jm, params, tm = cb if name == "entroformer_cb" else _pair(name, seed=1)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    oj = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(params, jnp.asarray(x))
    with torch.no_grad():
        ot = tm(_nchw(x))
        z3 = _nhwc(tm.analyze(_nchw(x)))
    mu_t, mu_j = _nhwc(ot.extras["means"]), np.asarray(oj.extras["means"])
    _close(mu_t, mu_j)
    _close(_nhwc(ot.extras["scales"]), oj.extras["scales"])
    np.testing.assert_array_equal(np.round(z3 - mu_t), np.round(z3 - mu_j))
    _close(_nhwc(ot.x_tilde), oj.x_tilde)
    np.testing.assert_allclose(float(ot.bpp), float(oj.bpp), rtol=ATOL)


def _port_grads(module):
    params = dict(module.named_parameters())
    return {key: to_flax_layout(mod, pname, params[skey].grad)
            for skey, key, mod, pname in flax_leaves(module)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_training_forward_and_gradients_match(cb):
    """B 2 at 64×64: the loss λ·255²·mse + bpp (+ the aux loss), its two
    noise draws (z, then y) recorded from JAX and replayed; every
    gradient within 1e-4 of its leaf's range."""
    jm, params, tm = cb
    x = np.random.default_rng(12).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": jax.random.PRNGKey(5)})
        aux = jm.apply({"params": p}, method=JCodecModel.entropy_aux_loss)
        loss = 0.0025 * 255 ** 2 * out.mse + out.bpp
        return loss + aux, (out.bpp, out.mse)

    jax.random.uniform = recording
    try:
        (loss_j, (bpp_j, mse_j)), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
    assert len(draws) == 2
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        a = a.transpose(0, 3, 1, 2) if a.ndim == 4 else a  # y's NHWC → NCHW
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

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
    got, ref = _port_grads(tm), _flat(grads_j)
    assert set(got) == set(ref)
    for k, r in ref.items():
        tol = max(1e-4 * float(np.abs(r).max()), 1e-7)
        assert float(np.abs(got[k] - r).max()) <= tol, k


# ------------------------------------------------------------- the coder


@pytest.fixture(scope="module")
def coders(cb):
    jm, params, tm = cb
    return JChannelCoder(jm, params, name="entroformer_cb"), ChannelCoder(tm, name="entroformer_cb")


def test_coder_rows_and_symbols_equal_jax(coders):
    """Both passes' σ-rows and symbols, in the stream's order (anchors,
    then non-anchors, each NHWC flat), equal the JAX coder's."""
    jc, tc = coders
    x = np.random.default_rng(8).uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    z3j = jc._analyze(jnp.asarray(x), jnp.float32(0.0))
    _, z_hat_j = jc._z_enc(z3j)
    sym_j, rows_j, _, _, _ = jc._slices_pass(z_hat_j, z3j, jnp.zeros((1, 256), jnp.int32),
                                              jnp.int32(0))
    with torch.no_grad():
        z3t = tc.model.analyze(_nchw(x))
        _, z_hat_t = tc._z_enc(z3t, 1)
        sym_t, rows_t, _, _ = tc._slices_pass(z_hat_t, 1, y=z3t)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(sym_t.numpy(), np.asarray(sym_j))
    assert tc._step_counts(4, 8) == jc._charm_step_counts(4, 8)


def test_ltc_streams_cross_both_ways(coders):
    jc, tc = coders
    x = np.random.default_rng(9).uniform(-1, 1, (2, 60, 100, 3)).astype(np.float32)
    jb = jc.compress_batch(jnp.asarray(x))
    tb = tc.compress_batch(_nchw(x))
    assert tb == jb
    with torch.no_grad():
        ref = torch.cat([tc.model(t).x_tilde for t in pad_to_multiple(_nchw(x), 64)[0].split(1)])
    rec_t = tc.decompress_batch(jb)
    torch.testing.assert_close(rec_t, ref[:, :, :60, :100], atol=ATOL, rtol=0)
    _close(np.asarray(jc.decompress(tb[1])), _nhwc(rec_t[1:]))
    assert tc.compress(_nchw(x[1:])) == tb[1]


def test_woken_eb_cdf_tables_equal_jax(cb):
    """The factorized prior's quantized CDF tables (the ``.ltc`` digest)
    with the EB's zero-init leaves (its ``factor_i``) set to seeded values,
    as a trained checkpoint has them, for six seeds: equal in both
    packages (ROADMAP §C7: the port's pmf table is XLA's float32, computed
    on the host by ``entropy/xla_f32.py``)."""
    jm, params, _ = cb
    for seed in range(11, 17):
        rng = np.random.default_rng(seed)
        eb = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
              if k.startswith("factor_") else v
              for k, v in params["entropy_bottleneck"].items()}
        woken = dict(params, entropy_bottleneck=eb)
        tm = build_model("entroformer_cb", device="cpu", n_override=N)
        tm.load_state_dict(params_from_flax(woken, PRESETS["entroformer_cb"]))
        pmf_j = jm.apply({"params": woken}, -Z_RANGE, Z_RANGE - 1,
                         method=JCodecModel.eb_pmf_table)
        med_j = jm.apply({"params": woken}, method=JCodecModel.eb_medians)
        with torch.no_grad():
            pmf_t = tm.eb_pmf_table(-Z_RANGE, Z_RANGE - 1)
            med_t = tm.eb_medians()
        want = JFactorizedCoder(np.asarray(pmf_j), np.asarray(med_j), -Z_RANGE).codec.cdfs
        got = FactorizedCoder(pmf_t.numpy(), med_t.detach().numpy(), -Z_RANGE).codec.cdfs
        np.testing.assert_array_equal(got, want, err_msg=f"EB woken with seed {seed}")
