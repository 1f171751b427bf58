"""Port parity of the U-Net hyper presets (``net_ha``, ``net_unet_ha_hs``,
``net_unet_ha_hs_1``) and of the syntax variants (``syntax_decoder=False``,
``syntax="none"``), against the JAX package on the CPU.

Weights: the port's seeded init at ``n_override=64``, every all-zero leaf
woken with seeded values (the zero-init residual outputs, WMSA's
``linear``, the biases, the entropy bottleneck's ``factor_i``) so that no
branch adds exactly 0, carried to the JAX package by ``utils.params``
(``flax_from_state``); its tree is the JAX init's, leaf for leaf and shape
for shape (``jax.eval_shape``).  The JAX side runs under ``jit``: at these
widths the whole forward compiles in about 15 s, where running it op by
op takes 40-70 s.  Inputs from numpy seeds.  Tolerances, fixed before
the first run:

* ``UnetHyperSynthesis`` with the encoder's skips, one and two heads:
  within 1e-4 of the output's largest magnitude;
* the eval forward of each preset at 128×128 (``assert_forwards_match``):
  z3, μ, σ and ŷ within 1e-4 of each one's largest magnitude, the
  symbols round(z3 − μ) equal, g_s on JAX's ŷ and the decode tail on
  JAX's g_s output within 1e-4 of each one's largest magnitude (stage by
  stage: the generated conv multiplies g_s's fp32 rounding, and g_s's
  output reaches a few hundred on these weights), bpp and bpp_z within
  1e-5 relative; the training forward with JAX's five noise draws
  replayed (z, then slices 0-3): bpp and MSE within 1e-5 relative;
* gradients of the U-Net hyper (analysis → the decoder on its skips)
  against ``jax.vjp`` for a random cotangent, for its input and every
  parameter, within 1e-4 of each gradient's largest magnitude, in
  float64 on both sides (in fp32 an activation within rounding of a kink
  takes the other branch in one package);
* the JAX package's own config cases (``tests/test_models.py:105-140``,
  ``tests/test_coverage.py:36-62``) on the same weights, as above;
* ``net_unet_ha_hs_1``'s syntax model, which nothing reads: no gradient,
  and a training step keeps it bit for bit (optax's Adam moves a leaf of
  zero gradient by exactly 0), also under DDP over two gloo processes,
  two steps.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import CodecConfig as JCodecConfig
from lic_tpu.models import hyper as jhyper
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.training.loss import rate_distortion_loss as jrate_distortion_loss
from lic_tpu_torch.config import CodecConfig, TrainConfig
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.codec import CodecModel
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.hyper import UnetHyperAnalysis, UnetHyperSynthesis
from lic_tpu_torch.models.presets import get_config as tget_config
from lic_tpu_torch.models.progressive import ProgressiveCoder
from lic_tpu_torch.training import create_state, make_optimizer, make_train_step
from lic_tpu_torch.training.loss import rate_distortion_loss
from lic_tpu_torch.utils.params import flax_from_state, flax_leaves, state_from_flax, to_flax_layout

torch.set_num_threads(2)

N = 64
ATOL = 1e-4
UNET_PRESETS = ("net_ha", "net_unet_ha_hs", "net_unet_ha_hs_1")
ALL_NEW = UNET_PRESETS + ("net_unet", "net_unet_1", "net_unet_005_5")


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _wake(module, seed):
    """Small seeded values for every all-zero parameter of ``module``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return module


def _tree(module, dtype=np.float32):
    """The module's parameters as the nested flax tree."""
    out = {}
    for key, a in flax_from_state(module).items():
        d = out
        *parents, leaf = key.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = a.astype(dtype)
    return out


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_by_range(got, want, what, tol=ATOL):
    scale = max(float(np.abs(want).max()), 1e-7)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)


_SHARED_MODELS, _TREE_SHAPES = {}, {}


def shared_model(preset):
    """``_tm(preset)``, built once per process and config for the tests
    that only read it (``net_unet_005_5`` is ``net_unet``'s config, its λ
    aside)."""
    key = repr(tget_config(preset, n_override=N))
    if key not in _SHARED_MODELS:
        _SHARED_MODELS[key] = _tm(preset)
    return _SHARED_MODELS[key]


def _tm(cfg_or_name, seed=0, **over):
    if isinstance(cfg_or_name, str):
        tm = build_model(cfg_or_name, device="cpu", n_override=N, seed=seed, **over)
    else:
        torch.manual_seed(seed)
        tm = CodecModel(cfg_or_name, generator=torch.Generator().manual_seed(seed)).eval()
    return _wake(tm, seed + 5)


def jax_tree_shapes(jm):
    """{flax path: shape} of the JAX init's parameters, once per config."""
    key = repr(jm.cfg)
    if key not in _TREE_SHAPES:
        shapes = jax.eval_shape(
            lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                              jnp.zeros((1, 128, 128, 3)), training=True),
            jax.random.PRNGKey(0))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
                for path, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
        _TREE_SHAPES[key] = {k: v for k, v in want.items()
                             if not k.startswith("prediction_model_syntax/")}
    return _TREE_SHAPES[key]


def jax_run(jm, tm, x, seed=5):
    """One ``jit`` of the JAX model with the port's weights on ``x``: the
    eval forward, the training forward (its noise draws recorded), z3, g_s
    on the eval forward's ŷ and the rounded syntax vector → (dict, draws)."""
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        # the entropy bottleneck draws inside a traced function
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    def run(m, v):
        ev = m(v, training=False)
        z3 = m.analyze(v)
        return dict(eval=ev, train=m(v, training=True), z3=z3, gs=m.g_s(ev.extras["y_hat"]),
                    syn=m.syntax_from_latent(z3) if m.cfg.syntax != "none" else None)

    jax.random.uniform = recording
    try:
        out = jax.jit(lambda p, v: jm.apply({"params": p}, v, method=run,
                                            rngs={"noise": jax.random.PRNGKey(seed)}))(
            _tree(tm), jnp.asarray(x))
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
    return out, draws


def port_run(tm, x, draws):
    """The port's eval and training forwards on ``x``, the training one on
    JAX's noise draws → (eval out, training out)."""
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        a = a.transpose(0, 3, 1, 2) if a.ndim == 4 else a  # the slices' NHWC → NCHW
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a))

    with torch.no_grad():
        ev = tm.eval()(_nchw(x))
        tr = tm.train()(_nchw(x), training=True, noise_fn=noise_fn)
    tm.eval()
    assert next(replay, None) is None
    return ev, tr


def assert_forwards_match(tm, x, jout, ot, tt):
    """The eval forward: μ, σ, ŷ, then g_s on JAX's ŷ and the decode tail on
    JAX's g_s output and syntax vector, each within 1e-4 of its range (stage
    by stage on the same inputs: the generated conv multiplies g_s's fp32
    rounding, and g_s's output reaches a few hundred on these weights); the
    symbols round(z3 − μ) equal; bpp and bpp_z within 1e-5 relative.  The
    training forward on the same noise: bpp and MSE within 1e-5 relative."""
    oj = jout["eval"]
    for k in ("means", "scales", "y_hat"):
        _close_by_range(_nhwc(ot.extras[k]), oj.extras[k], k)
    syn = None if jout["syn"] is None else _nchw(jout["syn"])
    with torch.no_grad():
        z3t = _nhwc(tm.analyze(_nchw(x)))
        _close_by_range(_nhwc(tm.g_s(_nchw(oj.extras["y_hat"]))), jout["gs"], "g_s")
        _close_by_range(_nhwc(tm._decode_tail(_nchw(jout["gs"]), syn)), oj.x_tilde, "x_tilde")
    z3j = np.asarray(jout["z3"])
    _close_by_range(z3t, z3j, "z3")
    np.testing.assert_array_equal(np.round(z3t - _nhwc(ot.extras["means"])),
                                  np.round(z3j - np.asarray(oj.extras["means"])))
    np.testing.assert_allclose([float(ot.bpp), float(ot.bpp_z)],
                               [float(oj.bpp), float(oj.bpp_z)], rtol=1e-5)
    tj = jout["train"]
    np.testing.assert_allclose([float(tt.bpp), float(tt.mse)], [float(tj.bpp), float(tj.mse)],
                               rtol=1e-5)


def jit_vjp(f):
    """(p, x, cotangent) → the gradients of ``f(p, x)`` for p and x, under
    ``jit``."""
    def g(p, v, ct):
        return jax.vjp(f, p, v)[1](ct)

    return lambda p, v, ct: jax.jit(g)(p, jnp.asarray(v), jax.tree.map(jnp.asarray, ct))


def assert_training_gradient_matches(fields, size):
    """The gradient of the training objective, ``λ·255²·MSE + bpp`` plus
    the aux loss (the JAX ``train_step``'s ``loss_fn``, λ the trainers'
    default), for the input image and every parameter of the model built
    from ``fields`` at ``n_override=N``, in float64 on both sides: the
    port's noise, drawn from a numpy seed, is replayed into the JAX
    forward in the order it draws.  The loss within 1e-5 relative (as the
    training forward's bpp and MSE), each
    gradient within 1e-4 of its largest magnitude, a parameter the port
    gives no gradient against JAX's, which must be exactly 0."""
    lmbda = TrainConfig().lmbda
    tm = _tm(CodecConfig(n_override=N, **fields)).double().train()
    jm = JCodecModel(JCodecConfig(n_override=N, **fields))
    x = _image((1, size, size, 3), 14).astype(np.float64)
    rng, draws = np.random.default_rng(15), []

    def noise_fn(shape, dtype, device):
        draws.append(rng.uniform(-0.5, 0.5, tuple(shape)))
        return torch.from_numpy(draws[-1]).to(dtype)

    v = _nchw(x).requires_grad_(True)
    out = tm(v, training=True, noise_fn=noise_fn)
    loss = rate_distortion_loss(out.bpp, out.mse, lmbda) + tm.entropy_aux_loss()
    loss.backward()

    replay = iter(a.transpose(0, 2, 3, 1) if a.ndim == 4 else a for a in draws)
    orig = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if np.dtype(dtype) != np.float64:  # an initializer, which flax runs for its shape
            return orig(key, shape, dtype, minval, maxval)
        a = next(replay)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a)

    def loss_fn(p, img):
        o = jm.apply({"params": p}, img, training=True, rngs={"noise": jax.random.PRNGKey(0)})
        aux = jm.apply({"params": p}, method=JCodecModel.entropy_aux_loss)
        return jrate_distortion_loss(o.bpp, o.mse, lmbda) + aux

    with jax.enable_x64(True):
        jax.random.uniform = uniform
        try:
            jloss, (gp, gx) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
                _tree(tm, np.float64), jnp.asarray(x))
            jloss, gp, gx = float(jloss), jax.tree.map(np.asarray, gp), np.asarray(gx)
        finally:
            jax.random.uniform = orig
    assert next(replay, None) is None
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _close_by_range(_nhwc(v.grad), gx, "input")
    flat, tparams = _flat(gp), dict(tm.named_parameters())
    for skey, key, module, pname in flax_leaves(tm):
        grad = tparams[skey].grad
        if grad is None:
            assert not flat[key].any(), key
        else:
            _close_by_range(to_flax_layout(module, pname, grad), flat[key], key)
    assert len(list(flax_leaves(tm))) == len(flat)
    return tm


# ------------------------------------------------------------ param trees

def assert_tree_both_ways(preset):
    """``flax_from_state`` gives the JAX init's tree; that tree, through
    ``state_from_flax``, fills a fresh port model leaf for leaf."""
    tm = shared_model(preset)
    jm = JCodecModel(jget_config(preset, n_override=N))
    assert {k: a.shape for k, a in flax_from_state(tm).items()} == jax_tree_shapes(jm)
    got = state_from_flax(_tree(tm), tm)
    want = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.detach()), k


@pytest.mark.parametrize("preset", UNET_PRESETS)
def test_parameter_tree_is_the_jax_init_tree_both_ways(preset):
    assert_tree_both_ways(preset)


def test_syntax_decoder_false_builds_what_jax_builds():
    tm = build_model("net_unet_ha_hs_1", device="cpu", n_override=N)
    names = {k.split("/")[0] for k in flax_from_state(tm)}
    assert "syntax_model" in names and "conv_weights_gen" not in names
    assert {"h_s_scale", "h_s_means", "entropy_bottleneck"} <= names and "h_s" not in names
    assert tm.g_s.up3.deconv.weight.shape[1] == 3  # g_s gives RGB
    assert tm.unread_parameters() == [f"syntax_model.{n}"
                                      for n, _ in tm.syntax_model.named_parameters()]
    for name in ("net_ha", "net_unet_ha_hs"):
        assert build_model(name, device="cpu", n_override=N).unread_parameters() == []


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("two_heads", [False, True])
def test_unet_hyper_synthesis_on_encoder_skips_matches(two_heads):
    tmod = _wake(UnetHyperSynthesis(N, N, two_heads=two_heads), 1)
    jmod = jhyper.UnetHyperSynthesis(N, two_heads=two_heads)
    rng = np.random.default_rng(2)
    middle = rng.standard_normal((1, 2, 3, 512)).astype(np.float32)
    skip1 = rng.standard_normal((1, 4, 6, 256)).astype(np.float32)
    inp = rng.standard_normal((1, 8, 12, N)).astype(np.float32)
    want = jmod.apply({"params": _tree(tmod)}, None, *map(jnp.asarray, (middle, skip1, inp)))
    with torch.no_grad():
        got = tmod(None, _nchw(middle), _nchw(skip1), _nchw(inp))
    got, want = (got, want) if two_heads else ((got,), (want,))
    for g, w in zip(got, want):
        _close_by_range(_nhwc(g), np.asarray(w), "h_s")


def test_unet_hyper_vjp_matches_jax_float64():
    """The U-Net hyper as the forward runs it: the decoder (two heads) on
    the analysis's skips; gradients for the latent and every parameter."""
    ha, hs = _wake(UnetHyperAnalysis(N), 3).double(), _wake(UnetHyperSynthesis(N, N, two_heads=True),
                                                           4).double()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 12, N))
    cts = (rng.standard_normal((1, 8, 12, N)), rng.standard_normal((1, 8, 12, N)))
    jha, jhs = jhyper.UnetHyperAnalysis(N), jhyper.UnetHyperSynthesis(N, two_heads=True)

    def f(p, v):
        _, middle, skip1, inp = jha.apply({"params": p["h_a"]}, v)
        return jhs.apply({"params": p["h_s"]}, None, middle, skip1, inp)

    with jax.enable_x64(True):
        params = {"h_a": _tree(ha, np.float64), "h_s": _tree(hs, np.float64)}
        gp, gx = jax.tree.map(np.asarray, jit_vjp(f)(params, x, cts))
    v = _nchw(x).requires_grad_(True)
    _, middle, skip1, inp = ha(v)
    s, m = hs(None, middle, skip1, inp)
    torch.autograd.backward((s, m), tuple(map(_nchw, cts)))
    _close_by_range(_nhwc(v.grad), gx, "input")
    checked = 0
    for name, mod in (("h_a", ha), ("h_s", hs)):
        flat = _flat(gp[name])
        tparams = dict(mod.named_parameters())
        for skey, key, module, pname in flax_leaves(mod):
            _close_by_range(to_flax_layout(module, pname, tparams[skey].grad), flat[key],
                            f"{name}/{key}")
            checked += 1
    assert checked == len(_flat(gp))


def test_training_gradient_of_the_whole_model_matches_jax_float64():
    """The U-Net hyper with two decoders and an RGB g_s (``net_unet_ha_hs_1``'s
    hyper and syntax fields, plain transforms): the EntropyBottleneck
    trains through the rate term and the aux loss alone, and the syntax
    model, which nothing reads, takes no gradient in either package."""
    tm = assert_training_gradient_matches(
        dict(family="charm", transform="plain", hyper="unet", shared_hyper_decoder=False,
             swatten=False, syntax="basic", syntax_decoder=False), 64)
    unread = set(tm.unread_parameters())
    assert unread and all(p.grad is None for n, p in tm.named_parameters() if n in unread)
    eb = [p.grad for n, p in tm.named_parameters() if n.startswith("entropy_bottleneck.")]
    assert eb and all(g is not None and g.any() for g in eb)


# ------------------------------------------------------- whole forwards

@pytest.mark.parametrize("preset", UNET_PRESETS)
def test_forward_matches_jax(preset):
    """The eval forward, and the training forward with JAX's noise."""
    tm = shared_model(preset)
    jm = JCodecModel(jget_config(preset, n_override=N))
    x = _image((1, 128, 128, 3), 10)
    jout, draws = jax_run(jm, tm, x)
    assert len(draws) == 5 and draws[0].ndim != 4  # z, then slices 0-3
    assert_forwards_match(tm, x, jout, *port_run(tm, x, draws))
    assert float(jout["eval"].bpp_z) > 0  # the EntropyBottleneck's z is counted


# the JAX package's config cases (tests/test_models.py, tests/test_coverage.py)
JAX_CASES = {
    "unet_shared_decoder": (dict(family="charm", transform="plain", hyper="unet",
                                 swatten=False, syntax="basic"), 128),
    "unet_separate_decoders": (dict(family="charm", transform="plain", hyper="unet",
                                    shared_hyper_decoder=False, swatten=False,
                                    syntax="basic"), 128),
    "direct_rgb_gs": (dict(family="charm", transform="plain", hyper="classic_dual",
                           swatten=False, syntax="basic", syntax_decoder=False), 64),
    "syntax_none": (dict(family="charm", transform="plain", hyper="classic_dual",
                         swatten=False, syntax="none"), 64),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_config_cases_match(case):
    fields, size = JAX_CASES[case]
    tm = _tm(CodecConfig(n_override=N, **fields))
    jm = JCodecModel(JCodecConfig(n_override=N, **fields))
    names = {k.split("/")[0] for k in flax_from_state(tm)}
    assert {k: a.shape for k, a in flax_from_state(tm).items()} == jax_tree_shapes(jm)
    assert ("syntax_model" in names) == (fields["syntax"] != "none")
    assert ("h_s_scale" in names) == (not fields.get("shared_hyper_decoder", True))
    x = _image((1, size, size, 3), 11)
    jout, draws = jax_run(jm, tm, x)
    ot, tt = port_run(tm, x, draws)
    assert ot.x_tilde.shape == (1, 3, size, size)
    assert_forwards_match(tm, x, jout, ot, tt)


def test_syntax_none_streams_carry_an_empty_syntax_field():
    """A decodable model without a syntax model codes as the JAX coder
    does: the header's syntax field is empty, the decode is the forward."""
    tm = build_model("source_net", device="cpu", n_override=32, syntax="none")
    x = _nchw(_image((1, 64, 64, 3), 12))
    coder = ChannelCoder(tm, name="source_net")
    blob = coder.compress_batch(x)[0]
    assert len(coder._parse_header(blob)[3]) == 0
    with torch.no_grad():
        ref = tm(x).x_tilde
    torch.testing.assert_close(coder.decompress_batch([blob]), ref, atol=ATOL, rtol=0)
    prog = ProgressiveCoder(tm, name="source_net")
    torch.testing.assert_close(prog.decompress(prog.compress(x)), ref, atol=ATOL, rtol=0)


# ------------------------------------------- coders, training, DDP, CLIs

@pytest.mark.parametrize("preset", ALL_NEW)
def test_coders_refuse_with_the_jax_reason(preset):
    tm = build_model(preset, device="cpu", n_override=N)
    hyper = tm.cfg.hyper
    for coder in (ChannelCoder, ProgressiveCoder):
        with pytest.raises(ValueError, match=f"hyper path '{hyper}' is not decodable"):
            coder(tm, name=preset)
    with pytest.raises(ValueError, match="not decodable"):
        tm.hyper_encode(torch.zeros(1, N, 4, 4))


def test_gradient_free_leaves_stay_bit_identical():
    """``net_unet_ha_hs_1``'s syntax model takes no gradient; a step leaves
    it bit for bit with no optimizer state while the group's count
    advances, as optax's Adam moves a leaf of zero gradient by 0."""
    import importlib

    import optax

    jtrain = importlib.import_module("lic_tpu.training.train")
    from lic_tpu.config import TrainConfig as JTrainConfig

    tm = _tm("net_unet_ha_hs_1").train()
    tc = TrainConfig()
    opt = make_optimizer(tm, tc, steps_per_epoch=10)
    state = create_state(tm, opt, tc.seed)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    metrics = make_train_step(tm, tc, opt)(state, _nchw(_image((1, 64, 64, 3), 13)))
    assert float(metrics["skipped"]) == 0.0
    unread = set(tm.unread_parameters())
    assert unread
    for name, p in tm.named_parameters():
        if name in unread:
            assert p.grad is None and torch.equal(p, before[name]), name
            assert p not in opt.main.state
        elif p.grad is not None and p.grad.any():
            assert not torch.equal(p, before[name]), name
    assert opt.main.param_groups[0]["count"] == 1 and opt.count == 1
    # optax: a zero gradient moves its leaf by exactly 0, at any step
    jopt = jtrain.make_optimizer(JTrainConfig(), 10)
    params = {"a": jnp.ones((3,)), "b": jnp.full((2,), 0.5)}
    st = jopt.init(params)
    for _ in range(2):
        upd, st = jopt.update({"a": jnp.ones((3,)), "b": jnp.zeros((2,))}, st, params)
        params = optax.apply_updates(params, upd)
    assert np.array_equal(np.asarray(params["b"]), np.full((2,), 0.5, np.float32))


def test_ddp_takes_two_steps_past_the_unread_leaves():
    """``tools.ddp_check`` on ``net_unet_ha_hs_1``: two gloo processes, two
    steps each, DDP-averaged gradients against one process; the unread
    syntax model stays out of DDP and takes no gradient on either side."""
    from lic_tpu_torch.tools import ddp_check

    args = argparse.Namespace(world=2, preset="net_unet_ha_hs_1", batch=2, size=64,
                              device="cpu", n_override=N, tol=1e-5, timeout=300.0)
    report = ddp_check.run(args)
    total = sum(1 for _ in build_model("net_unet_ha_hs_1", device="cpu",
                                       n_override=N).named_parameters())
    assert report["params_with_gradient"] < total
    assert report["max_share_of_range"] <= 1e-5, report["by_module"]


def test_train_cli_defaults_to_the_jax_trainers_preset():
    from lic_tpu.cli import train as jcli
    from lic_tpu_torch.cli import train as tcli

    args = ["--train_data_path", "x"]
    assert tcli.build_parser().parse_args(args).preset == "net_unet_ha_hs"
    assert tcli.build_parser().parse_args(args).preset == jcli.build_parser().parse_args(
        args).preset


def test_codec_cli_refuses_with_the_coders_reason(tmp_path, monkeypatch):
    from PIL import Image

    import lic_tpu_torch.models as tmodels
    from lic_tpu_torch.cli import codec as ccli
    from lic_tpu_torch.utils.checkpoint import save_params

    orig = tmodels.build_model
    monkeypatch.setattr(tmodels, "build_model",
                        lambda name, **kw: orig(name, **{**kw, "n_override": N}))
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(tmp_path / "a.png")
    save_params(str(tmp_path / "w.npz"), build_model("net_unet_ha_hs", device="cpu",
                                                     n_override=N))
    for extra in ([], ["--progressive"]):
        with pytest.raises(ValueError, match="hyper path 'unet' is not decodable"):
            ccli.main(["compress", str(tmp_path / "a.png"), str(tmp_path / "a.ltc"),
                       "--weight_path", str(tmp_path / "w.npz"), "--preset", "net_unet_ha_hs",
                       "--device", "cpu", *extra])
