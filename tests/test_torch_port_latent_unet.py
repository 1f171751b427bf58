"""Port parity of the latent U-Net presets (``net_unet``, ``net_unet_1``,
``net_unet_005_5``) and of their layers (``layers.spatial_transformer``,
``models.hyper.LatentUnet``), against the JAX package on the CPU.

Weights and inputs as in ``test_torch_port_unet.py`` (the port's seeded
init, every all-zero leaf woken, carried to the JAX package by
``utils.params``; numpy seeds; the JAX models and ``LatentUnet``'s
gradient under ``jit``, the small layers op by op).  Tolerances, fixed
before the first run:

* GEGLU, FeedForward, CrossAttention (self and with a context),
  BasicTransformerBlock, ``SpatialTransformer`` at depth 2 and
  ``LatentUnet`` in both variants with one and two heads: within 1e-4 of
  the output's largest magnitude; ``remat`` gives the same output and
  gradients, bit for bit;
* gradients of ``LatentUnet`` (both variants, two heads: the shared
  stage-2 modules sum the down and the up path's gradients) against
  ``jax.vjp`` for a random cotangent, for its input and every parameter,
  within 1e-4 of each gradient's largest magnitude, in float64 on both
  sides (in fp32 a ReLU whose input lies within rounding of 0 takes the
  other branch in one package);
* the eval forward of ``net_unet`` at 128×128 (``net_unet_1`` differs
  from it only in the ``LatentUnet`` variant, held above) and
  the training forward with JAX's four noise draws replayed (the slices
  only: no z), as ``test_torch_port_unet.assert_forwards_match`` holds
  them, with bpp_z exactly 0 in both packages;
* the JAX package's latent U-Net config cases
  (``tests/test_models.py:105-112``, ``tests/test_coverage.py:46-62``),
  the same;
* no EntropyBottleneck: the aux loss is 0, the optimizer has no aux
  group, a training step moves every leaf that took a gradient;
* evaluation: ``evaluate_image`` scores the eval forward, and
  ``content_adaptive_finetune`` tunes g_a alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import CodecConfig as JCodecConfig
from lic_tpu.layers import spatial_transformer as jst
from lic_tpu.models import hyper as jhyper
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.config import CodecConfig, EvalConfig, TrainConfig
from lic_tpu_torch.evaluation import content_adaptive_finetune, evaluate_image
from lic_tpu_torch.layers import (
    GEGLU,
    BasicTransformerBlock,
    CrossAttention,
    FeedForward,
    SpatialTransformer,
)
from lic_tpu_torch.models.hyper import LatentUnet
from lic_tpu_torch.training import create_state, make_optimizer, make_train_step
from lic_tpu_torch.utils.params import flax_from_state, flax_leaves, to_flax_layout
from test_torch_port_unet import (
    N,
    _close_by_range,
    _flat,
    _image,
    _nchw,
    _nhwc,
    _tm,
    _tree,
    shared_model,
    _wake,
    assert_forwards_match,
    assert_training_gradient_matches,
    assert_tree_both_ways,
    jax_run,
    jax_tree_shapes,
    jit_vjp,
    port_run,
)

torch.set_num_threads(2)

LATENT_PRESETS = ("net_unet", "net_unet_1", "net_unet_005_5")


@pytest.mark.parametrize("preset", LATENT_PRESETS)
def test_parameter_tree_is_the_jax_init_tree_both_ways(preset):
    assert_tree_both_ways(preset)


# ---------------------------------------------------------------- layers

def _pieces(kind):
    """(JAX module, port module, input shapes) of one transformer piece."""
    return {
        "geglu": (jst.GEGLU(48), GEGLU(32, 48), [(2, 12, 32)]),
        "feedforward": (jst.FeedForward(32), FeedForward(32), [(2, 12, 32)]),
        "attention": (jst.CrossAttention(32, 4, 8), CrossAttention(32, 4, 8), [(2, 12, 32)]),
        "cross_attention": (jst.CrossAttention(32, 4, 8), CrossAttention(32, 4, 8, context_dim=24),
                            [(2, 12, 32), (2, 7, 24)]),
        "block": (jst.BasicTransformerBlock(32, 4, 8), BasicTransformerBlock(32, 4, 8),
                  [(2, 12, 32)]),
    }[kind]


@pytest.mark.parametrize("kind", ["geglu", "feedforward", "attention", "cross_attention",
                                  "block"])
def test_transformer_pieces_match_jax(kind):
    jmod, tmod, shapes = _pieces(kind)
    _wake(tmod, 1)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jmod.apply({"params": _tree(tmod)}, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs))
    _close_by_range(got.numpy(), np.asarray(want), kind)


def test_spatial_transformer_matches_jax_and_remat_changes_nothing():
    """Depth 2 on a 6×10 map (GroupNorm(32) over 64 channels, 8 heads of
    8); ``remat`` in training gives the same output and gradients."""
    tmod = _wake(SpatialTransformer(64, 8, 8, depth=2), 3)
    x = np.random.default_rng(4).standard_normal((2, 6, 10, 64)).astype(np.float32)
    want = jst.SpatialTransformer(64, 8, 8, depth=2).apply({"params": _tree(tmod)},
                                                          jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    _close_by_range(_nhwc(got), np.asarray(want), "spatial_transformer")
    assert {k.split("/")[0] for k in flax_from_state(tmod)} == {
        "norm", "proj_in", "block_0", "block_1", "proj_out"}
    outs, grads = [], []
    for remat in (False, True):
        tmod.remat = remat
        tmod.train().zero_grad()
        v = _nchw(x).requires_grad_(True)
        y = tmod(v)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append([v.grad] + [p.grad.clone() for p in tmod.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


LATENT_CASES = [("res", False), ("res", True), ("conv1x1", False), ("conv1x1", True)]


@pytest.mark.parametrize("variant,two_heads", LATENT_CASES)
def test_latent_unet_matches_jax(variant, two_heads):
    tmod = _wake(LatentUnet(N, N, variant=variant, two_heads=two_heads), 5)
    jmod = jhyper.LatentUnet(N, N, variant=variant, two_heads=two_heads)
    x = np.random.default_rng(6).standard_normal((1, 8, 12, N)).astype(np.float32)
    want = jax.jit(lambda p, v: jmod.apply({"params": p}, v))(_tree(tmod), jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    got, want = (got, want) if two_heads else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_by_range(_nhwc(g), np.asarray(w), "latent_unet")
    # the stage-2 transformer is one module (and the conv too under 'res')
    top = {k.split("/")[0] for k in flax_from_state(tmod)}
    assert ("cb4" in top) == (variant == "conv1x1") and ("up4b" in top) == two_heads
    assert {"st1", "st2", "st3", "mid_0", "mid_1", "mid_2"} <= top


@pytest.mark.parametrize("variant", ["res", "conv1x1"])
def test_latent_unet_vjp_matches_jax_float64(variant):
    tmod = _wake(LatentUnet(N, N, variant=variant, two_heads=True), 7).double()
    jmod = jhyper.LatentUnet(N, N, variant=variant, two_heads=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 8, 12, N))
    cts = (rng.standard_normal((1, 8, 12, N)), rng.standard_normal((1, 8, 12, N)))
    with jax.enable_x64(True):
        gp, gx = jax.tree.map(np.asarray, jit_vjp(lambda p, v: jmod.apply({"params": p}, v))(
            _tree(tmod, np.float64), x, cts))
    v = _nchw(x).requires_grad_(True)
    torch.autograd.backward(tmod(v), tuple(map(_nchw, cts)))
    _close_by_range(_nhwc(v.grad), gx, "input")
    flat, tparams = _flat(gp), dict(tmod.named_parameters())
    for skey, key, module, pname in flax_leaves(tmod):
        _close_by_range(to_flax_layout(module, pname, tparams[skey].grad), flat[key], key)
    assert len(list(flax_leaves(tmod))) == len(flat)


# ------------------------------------------------------- whole forwards

@pytest.mark.parametrize("preset", ["net_unet"])
def test_forward_matches_jax(preset):
    tm = shared_model(preset)
    jm = JCodecModel(jget_config(preset, n_override=N))
    x = _image((1, 128, 128, 3), 10)
    jout, draws = jax_run(jm, tm, x)
    assert len(draws) == 4 and all(d.ndim == 4 for d in draws)  # the slices, no z
    ot, tt = port_run(tm, x, draws)
    assert_forwards_match(tm, x, jout, ot, tt)
    assert float(ot.bpp_z) == 0.0 and float(jout["eval"].bpp_z) == 0.0
    assert float(tt.bpp_z) == 0.0


# the JAX package's latent U-Net cases (tests/test_models.py, tests/test_coverage.py)
JAX_CASES = {
    "latent_unet_uncoded": dict(family="charm", transform="plain", hyper="latent_unet",
                                swatten=False, syntax="basic", count_hyper_bpp=False),
    "latent_unet_conv1x1": dict(family="charm", transform="plain", hyper="latent_unet",
                                unet_variant="conv1x1", swatten=False, syntax="basic",
                                count_hyper_bpp=False),
    "latent_unet_separate_decoders": dict(family="charm", transform="plain",
                                          hyper="latent_unet", shared_hyper_decoder=False,
                                          swatten=False, syntax="basic",
                                          count_hyper_bpp=False),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_config_cases_match(case):
    fields = JAX_CASES[case]
    tm = _tm(CodecConfig(n_override=N, **fields))
    jm = JCodecModel(JCodecConfig(n_override=N, **fields))
    names = {k.split("/")[0] for k in flax_from_state(tm)}
    assert {k: a.shape for k, a in flax_from_state(tm).items()} == jax_tree_shapes(jm)
    assert ("unet_b" in names) == (not fields.get("shared_hyper_decoder", True))
    assert "entropy_bottleneck" not in names and "h_a" not in names
    x = _image((1, 64, 64, 3), 11)
    jout, draws = jax_run(jm, tm, x)
    ot, tt = port_run(tm, x, draws)
    assert ot.x_tilde.shape == (1, 3, 64, 64) and float(tt.bpp_z) == 0.0
    assert_forwards_match(tm, x, jout, ot, tt)


# ---------------------------------------------- training and evaluation

def test_training_gradient_of_the_whole_model_matches_jax_float64():
    """The latent U-Net with two heads (the ``latent_unet_uncoded`` case,
    plain transforms) at 64×64: the training objective's gradient for the
    image and every leaf, the slices and g_s included, against JAX's."""
    tm = assert_training_gradient_matches(JAX_CASES["latent_unet_uncoded"], 64)
    assert all(p.grad is not None for p in tm.parameters())

def test_no_entropy_bottleneck_no_aux_group_and_a_step_moves_every_leaf():
    tm = _tm("net_unet").train()
    assert float(tm.entropy_aux_loss()) == 0.0
    assert not hasattr(tm, "entropy_bottleneck") and tm.unread_parameters() == []
    tc = TrainConfig()
    opt = make_optimizer(tm, tc, steps_per_epoch=10)
    assert opt.aux is None
    state = create_state(tm, opt, tc.seed)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    metrics = make_train_step(tm, tc, opt)(state, _nchw(_image((1, 64, 64, 3), 12)))
    assert float(metrics["skipped"]) == 0.0 and float(metrics["aux"]) == 0.0
    assert np.isfinite(float(metrics["loss"]))
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        if p.grad.any():
            assert not torch.equal(p, before[name]), name


def test_evaluate_image_and_tune_on_the_latent_unet():
    """``evaluate_image`` scores the eval forward (bpp_z is 0: nothing is
    coded on the hyper path); the tune moves g_a alone."""
    tm = _tm("net_unet_1")
    x = _nchw(_image((1, 64, 64, 3), 13))
    with torch.no_grad():
        out = tm(x)
    r = evaluate_image(tm, x)
    np.testing.assert_allclose(r["bpp"], float(out.bpp), rtol=1e-6)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tuned = content_adaptive_finetune(tm, x, EvalConfig(tune_iters=2))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k  # the model given stays as it was
    moved = {k for k, v in tuned.state_dict().items() if not torch.equal(v, before[k])}
    assert moved and all(k.startswith("g_a.") for k in moved)
