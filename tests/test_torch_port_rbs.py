"""Port parity of the ``rbs`` synthesis transform and of the ChARM codec
without LRP, against the JAX package on the CPU.

Configs: ``net_ga`` with ``transform="rbs"`` (the rich g_a, the
``synthesisTransformModel_RBS`` g_s) and ``source_net`` with
``lrp=False``, at ``n_override=32``.  Weights: the port's seeded init,
every all-zero leaf woken with seeded values of scale 0.01, carried to the
JAX package by ``utils.params``; inputs from numpy seeds.  (At the U-Net
tests' wake of 0.05, the woken convs feeding the rbs g_s's IGDNs square
the map at each of its seven IGDNs: g_s reaches 1e21 on a 128×128 image
and overflows fp32 in both packages alike; at 0.01 it stays at the 4e3
of the unwoken init.)  Tolerances, fixed before
the first run:

* ``ResidualBlockUpsample`` (C_in 32 and 160: the B6 slot's plain version
  on the CPU) and the rbs g_s: within 1e-4 of the output's largest
  magnitude;
* the eval forward of both configs at 128×128: z3, μ, σ, ŷ and g_s (on
  JAX's ŷ) within 1e-4 of each one's range, the symbols round(z3 − μ)
  equal, bpp and bpp_z within 1e-5 relative.  ``lrp=False`` also as the
  U-Net test's ``assert_forwards_match`` does: the decode tail on JAX's
  g_s output within 1e-4 of its range, and the training forward on JAX's
  noise draws (bpp and MSE within 1e-5 relative).  The rbs g_s output
  reaches 4e3 at this init, so its tail is held before the tanh: the
  generated conv's weights and its output on JAX's g_s output, each
  within 1e-4 of its range (after the tanh, fp32 rounding of a sum of
  terms of 4e3 is 1e-4 of the tanh's range);
* the training objective's gradient through the rbs synthesis
  (λ·255²·MSE of the decode tail of g_s(ŷ), the syntax vector given)
  against ``jax.value_and_grad`` in float64, for ŷ and every parameter of
  g_s and of the generated conv: the loss within 1e-5 relative, each
  gradient within 1e-5 of its largest magnitude.  The JAX package asks
  for fp32 accumulation in its window attention's and 1×1 convs'
  contractions (``preferred_element_type``); the test drops that request
  for float64 operands, so both sides run float64 throughout;
* the ``lrp=False`` ``ChannelCoder``: the JAX coder's bytes, and the decode
  within 1e-4 of the eval forward; the rbs roundtrip decodes to the
  port's forward within 1e-4 (g_s is not on the entropy path);
* the parameter trees are the JAX init's, and ``.npz`` files of either
  package load strictly into the other.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import CodecConfig as JCodecConfig
from lic_tpu.layers import blocks as jblocks
from lic_tpu.models import transforms as jtransforms
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import PRESETS as JPRESETS
from lic_tpu.models.syntax import batch_conv as jbatch_conv
from lic_tpu.training.loss import rate_distortion_loss as jrate_distortion_loss
from lic_tpu.utils import checkpoint as jckpt
from lic_tpu_torch.config import TrainConfig
from lic_tpu_torch.layers import ResidualBlockUpsample
from lic_tpu_torch.models.codec import CodecModel, check_supported
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.models.syntax import batch_conv
from lic_tpu_torch.training.loss import rate_distortion_loss
from lic_tpu_torch.models.transforms import SynthesisTransform
from lic_tpu_torch.utils import checkpoint as tckpt
from lic_tpu_torch.utils.params import (
    flax_from_state,
    flax_leaves,
    state_from_flax,
    to_flax_layout,
)
from test_torch_port_unet import (
    _close_by_range,
    _flat,
    _image,
    _nchw,
    _nhwc,
    _tree,
    _wake,
    assert_forwards_match,
    jax_run,
    port_run,
)

NS = 32
CONFIGS = {
    "rbs": dataclasses.replace(PRESETS["net_ga"], transform="rbs", n_override=NS),
    "nolrp": dataclasses.replace(PRESETS["source_net"], lrp=False, n_override=NS),
}
_MODELS, _SHAPES = {}, {}


def _wake_small(module, seed, scale=0.01):
    """Seeded values of ``scale`` for every all-zero parameter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(scale * torch.randn(p.shape, generator=g))
    return module


def model(name):
    """The port model of ``CONFIGS[name]``, seeded and woken, once per
    process (the tests only read it)."""
    if name not in _MODELS:
        m = CodecModel(CONFIGS[name], generator=torch.Generator().manual_seed(0)).eval()
        _MODELS[name] = _wake_small(m, 5)
    return _MODELS[name]


def jax_shapes(name):
    """The JAX init's parameter tree as ``ShapeDtypeStruct``s, once per
    config."""
    if name not in _SHAPES:
        _SHAPES[name] = jax.eval_shape(
            lambda k: jmodel(name).init({"params": k, "noise": jax.random.PRNGKey(1)},
                                        jnp.zeros((1, 128, 128, 3)), training=True),
            jax.random.PRNGKey(0))["params"]
    return _SHAPES[name]


def jmodel(name):
    return JCodecModel(JCodecConfig(**{f.name: getattr(CONFIGS[name], f.name)
                                       for f in dataclasses.fields(JCodecConfig)}))


def test_configs_are_the_presets_with_one_field_changed():
    assert JPRESETS["net_ga"].replace(transform="rbs", n_override=NS) == jmodel("rbs").cfg
    for name in CONFIGS:
        check_supported(CONFIGS[name])  # refuses nothing
    assert not hasattr(model("nolrp"), "lrp_transforms")
    assert type(model("rbs").g_a).__name__ == "AnalysisTransform"
    assert hasattr(model("rbs").g_a, "rbs1") and hasattr(model("rbs").g_s, "rbs_up2")


@pytest.mark.parametrize("cin", [32, 160])
def test_residual_block_upsample_matches_jax(cin):
    """C_in 160 puts the 3×3 in kernel B6's slot (its plain version here)."""
    tm = _wake(ResidualBlockUpsample(cin, cin, 2, generator=torch.Generator().manual_seed(1)), 2)
    x = _image((2, 6, 8, cin), 3)
    want = jblocks.ResidualBlockUpsample(cin, 2).apply({"params": _tree(tm)}, jnp.asarray(x))
    assert tm.conv.kernel_slot(torch.zeros(1, cin, 12, 16)) == ("convk_s1" if cin > 128 else None)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == (2, 12, 16, cin)
    _close_by_range(got, want, "ResidualBlockUpsample")


def test_rbs_synthesis_matches_jax():
    tm = _wake(SynthesisTransform(NS, 16, "rbs", generator=torch.Generator().manual_seed(4)), 6)
    y = _image((1, 4, 6, NS), 7) * 0.5
    want = jax.jit(lambda p, v: jtransforms.SynthesisTransform(NS, 16, "rbs").apply(
        {"params": p}, v))(_tree(tm), jnp.asarray(y))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(y)))
    assert got.shape == (1, 64, 96, 16)
    _close_by_range(got, want, "rbs g_s")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parameter_tree_is_the_jax_init_tree(name):
    tm = model(name)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(jax_shapes(name))[0]}
    want = {k: v for k, v in want.items() if not k.startswith("prediction_model_syntax/")}
    assert {k: a.shape for k, a in flax_from_state(tm).items()} == want
    got = state_from_flax(_tree(tm), tm)
    for k, v in tm.named_parameters():
        assert torch.equal(got[k], v.detach()), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_npz_loads_strictly_both_ways(name, tmp_path):
    tm = model(name)
    tckpt.save_params(str(tmp_path / "t.npz"), tm)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax_shapes(name))
    jparams = jckpt.load_params(str(tmp_path / "t.npz"), template, strict=True)
    jckpt.save_params(str(tmp_path / "j.npz"), jparams)
    fresh = CodecModel(CONFIGS[name], generator=torch.Generator().manual_seed(9))
    tckpt.load_params(str(tmp_path / "j.npz"), fresh, strict=True)
    for (k, a), (_, b) in zip(tm.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), k


def test_nolrp_forward_matches_jax():
    tm = model("nolrp")
    x = _image((1, 128, 128, 3), 11)
    jout, draws = jax_run(jmodel("nolrp"), tm, x)
    ot, tt = port_run(tm, x, draws)
    assert ot.x_tilde.shape == (1, 3, 128, 128)
    assert_forwards_match(tm, x, jout, ot, tt)


def test_rbs_forward_matches_jax():
    tm, jm = model("rbs"), jmodel("rbs")
    x = _image((1, 128, 128, 3), 11)
    tree = _tree(tm)

    def run(m, v):
        ev = m(v, training=False)
        z3 = m.analyze(v)
        syn = m.syntax_from_latent(z3)
        return dict(eval=ev, z3=z3, gs=m.g_s(ev.extras["y_hat"]), syn=syn,
                    w=m.conv_weights_gen(syn))

    jout = jax.jit(lambda p, v: jm.apply({"params": p}, v, method=run))(tree, jnp.asarray(x))
    oj = jout["eval"]
    with torch.no_grad():
        ot = tm(_nchw(x))
        z3t = _nhwc(tm.analyze(_nchw(x)))
        gs_t = tm.g_s(_nchw(oj.extras["y_hat"]))
        w_t = tm.conv_weights_gen(_nchw(jout["syn"]))
        pre_t = batch_conv(w_t, _nchw(jout["gs"]))
    assert ot.x_tilde.shape == (1, 3, 128, 128)
    for k in ("means", "scales", "y_hat"):
        _close_by_range(_nhwc(ot.extras[k]), oj.extras[k], k)
    _close_by_range(z3t, jout["z3"], "z3")
    np.testing.assert_array_equal(np.round(z3t - _nhwc(ot.extras["means"])),
                                  np.round(np.asarray(jout["z3"]) - np.asarray(oj.extras["means"])))
    np.testing.assert_allclose([float(ot.bpp), float(ot.bpp_z)],
                               [float(oj.bpp), float(oj.bpp_z)], rtol=1e-5)
    _close_by_range(_nhwc(gs_t), jout["gs"], "g_s")
    _close_by_range(w_t.numpy(), jout["w"], "generated weights")
    _close_by_range(_nhwc(pre_t), jbatch_conv(jout["w"], jout["gs"]), "generated conv")


def _float64_contractions(fn):
    """``fn`` with a float32 ``preferred_element_type`` dropped where an
    operand is float64."""
    def wrapped(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32 and any(
                getattr(a, "dtype", None) == jnp.float64 for a in args):
            preferred_element_type = None
        return fn(*args, preferred_element_type=preferred_element_type, **kw)

    return wrapped


def test_rbs_synthesis_training_gradient_matches_jax_float64(monkeypatch):
    monkeypatch.setattr(jax.lax, "dot_general", _float64_contractions(jax.lax.dot_general))
    monkeypatch.setattr(jnp, "einsum", _float64_contractions(jnp.einsum))
    lmbda = TrainConfig().lmbda
    tm = copy.deepcopy(model("rbs")).double().train()
    jm = jmodel("rbs")
    rng = np.random.default_rng(16)
    y = np.round(rng.normal(0, 2, (1, 4, 4, NS)))
    syn = np.round(rng.normal(0, 2, (1, 1, 1, 16)))
    x = _image((1, 64, 64, 3), 17).astype(np.float64)

    yt = _nchw(y).requires_grad_(True)
    out = tm._decode_tail(tm.g_s(yt), _nchw(syn))
    loss = rate_distortion_loss(torch.zeros((), dtype=torch.float64),
                                torch.mean((out - _nchw(x)) ** 2), lmbda)
    loss.backward()

    def loss_fn(p, v):
        o = jm.apply({"params": p}, v, jnp.asarray(syn),
                     method=lambda m, a, s: m._decode_tail(m.g_s(a), s))
        return jrate_distortion_loss(jnp.zeros(()), jnp.mean((o - jnp.asarray(x)) ** 2), lmbda)

    with jax.enable_x64(True):
        jloss, (gp, gy) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
            _tree(tm, np.float64), jnp.asarray(y))
        jloss, gp, gy = float(jloss), jax.tree.map(np.asarray, gp), np.asarray(gy)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _close_by_range(_nhwc(yt.grad), gy, "y_hat", tol=1e-5)
    flat, tparams, n = _flat(gp), dict(tm.named_parameters()), 0
    for skey, key, module, pname in flax_leaves(tm):
        if key.split("/")[0] in ("g_s", "conv_weights_gen"):
            _close_by_range(to_flax_layout(module, pname, tparams[skey].grad), flat[key], key,
                            tol=1e-5)
            n += 1
    assert n == sum(1 for k in flat if k.split("/")[0] in ("g_s", "conv_weights_gen")) > 100


def test_nolrp_coder_writes_the_jax_bytes_and_decodes_to_the_forward():
    tm, name = model("nolrp"), "source_net+nolrp"
    x = _image((1, 128, 128, 3), 12)
    blob = ChannelCoder(tm, name=name).compress(_nchw(x))
    jblob = JChannelCoder(jmodel("nolrp"), _tree(tm), name=name).compress(jnp.asarray(x))
    assert blob == jblob
    with torch.no_grad():
        rec = ChannelCoder(tm, name=name).decompress(jblob)
        fwd = tm(_nchw(x)).x_tilde
    assert float((rec - fwd).abs().max()) <= 1e-4


def test_rbs_roundtrip_decodes_to_the_forward():
    tm = model("rbs")
    x = _image((2, 128, 128, 3), 13)
    coder = ChannelCoder(tm)
    rec = coder.decompress_batch(coder.compress_batch(_nchw(x)))
    with torch.no_grad():
        fwd = torch.cat([tm(_nchw(x[i : i + 1])).x_tilde for i in range(2)])
    assert rec.shape == fwd.shape == (2, 3, 128, 128)
    assert float((rec - fwd).abs().max()) <= 1e-4
