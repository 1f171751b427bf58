"""Port parity of training (ROADMAP A12) against the JAX package, on the CPU.

``source_net`` with ``n_override=32``, batch 2 at 64×64, weights from the
JAX package's own init carried over by ``params_from_flax``.  Tolerances,
fixed before the first run:

* the straight-through ops (``lower_bound``, ``upper_bound``,
  ``ste_round``, ``bypass_round``, ``quantize_ste_offset``): forward and
  gradient bit-exact in fp32;
* B2's ``gdn_plain_backward`` against ``_gdn_fused_bwd``: atol/rtol 1e-5;
  the autograd.Functions of B3/B6/B4/B5 (on the CPU their forward is the
  plain version, their backward the one the card runs) against
  ``jax.vjp`` of the JAX module: every gradient within 1e-4 of the JAX
  leaf's max-abs;
* the training forward with JAX's five noise draws replayed (recorded by
  wrapping ``jax.random.uniform`` in this file): ``loss``, ``bpp``,
  ``mse``, ``aux`` at rtol 1e-5, and every parameter gradient of
  ``loss + aux`` within 1e-4 × the JAX leaf's max-abs (floor 1e-7);
* the optimizer against ``lic_tpu.training.make_optimizer`` on the same
  gradients: parameters within 1e-6 of the largest update so far;
* schedules rtol 1e-6; ``ssim``/``ms_ssim``/``msssim_db``/the R-D loss
  rtol 1e-5;
* two gloo processes with DDP (``tools.ddp_check``) against the
  single-process gradient of the whole batch: within 1e-5 × each leaf's
  max-abs.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lic_tpu.config import TrainConfig as JTrainConfig
from lic_tpu.layers import conv as jconv
from lic_tpu.layers.blocks import ResidualBlock as JResidualBlock
from lic_tpu.layers.pallas_gdn import _gdn_fused_bwd, gdn_fused as jgdn_fused
from lic_tpu.layers.win_attention import WinBasedAttention as JWinBasedAttention
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.ops.bounds import lower_bound as jlower_bound, upper_bound as jupper_bound
from lic_tpu.ops.rounding import (
    noise_quant as jnoise_quant,
    quantize_ste_offset as jquantize_ste_offset,
    ste_round as jste_round,
)
from lic_tpu.training import loss as jloss, schedule as jschedule
from lic_tpu.training.train import make_optimizer as jmake_optimizer

from lic_tpu_torch.config import TrainConfig
from lic_tpu_torch.layers import Conv2d, ResidualBlock, WinBasedAttention
from lic_tpu_torch.layers import conv_direct, gdn as tgdn, window_attn
from lic_tpu_torch.models import build_model
from lic_tpu_torch.ops import (
    bypass_round,
    lower_bound,
    noise_quant,
    quantize_ste_offset,
    ste_round,
    uniform_noise,
    upper_bound,
)
from lic_tpu_torch.training import loss as tloss, schedule as tschedule
from lic_tpu_torch.training.train import CodecOptimizer, aux_labels, make_optimizer
from lic_tpu_torch.utils.params import (
    SKIPPED_PREFIX,
    flax_leaves,
    params_from_flax,
    state_from_flax,
    to_flax_layout,
)
from jax_params import init_params

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_grads(module):
    """Gradients of ``module``'s parameters in the flax layout, by flax key."""
    params = dict(module.named_parameters())
    return {key: to_flax_layout(mod, pname, params[skey].grad)
            for skey, key, mod, pname in flax_leaves(module)}


def _assert_grads_close(got, ref, share, floor=1e-7):
    """Every leaf of ``ref`` (flax keys → arrays): ``got`` within ``share``
    of the leaf's max-abs (at least ``floor``)."""
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k, r in ref.items():
        tol = max(share * float(np.abs(r).max()), floor)
        err = float(np.abs(got[k] - r).max())
        assert err <= tol, f"{k}: {err:.3g} > {tol:.3g}"


# ------------------------------------------------------------- (a) STE ops


@pytest.mark.parametrize("bound", [0.11, 1e-9, -0.3])
def test_bounds_forward_and_gradient_bitexact(bound):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 0.5).astype(np.float32)
    x[:8] = bound  # ties: x == bound passes the gradient
    g = rng.standard_normal(4096).astype(np.float32)
    for jf, tf in ((jlower_bound, lower_bound), (jupper_bound, upper_bound)):
        y, vjp = jax.vjp(lambda a: jf(a, jnp.asarray(bound, jnp.float32)), jnp.asarray(x))
        xt = torch.from_numpy(x.copy()).requires_grad_()
        yt = tf(xt, bound)
        yt.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
        with torch.no_grad():  # the eval path: plain clamp, the same values
            np.testing.assert_array_equal(tf(torch.from_numpy(x), bound).numpy(), np.asarray(y))


def test_ste_round_forward_and_gradient_bitexact():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:6] = [0.5, 1.5, -0.5, -2.5, 2.5000002, 0.49999997]
    off = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    cases = [
        (jste_round, ste_round, (x,)),
        (jste_round, bypass_round, (x,)),
        (jquantize_ste_offset, quantize_ste_offset, (x, off)),
    ]
    for jf, tf, args in cases:
        y, vjp = jax.vjp(jf, *map(jnp.asarray, args))
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        yt = tf(*ts)
        yt.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
        for t, gj in zip(ts, vjp(jnp.asarray(g))):
            np.testing.assert_array_equal(t.grad.numpy(), np.asarray(gj))
        with torch.no_grad():
            np.testing.assert_array_equal(tf(*map(torch.from_numpy, args)).numpy(),
                                          np.asarray(y))


def test_noise_quant_matches_jax():
    """Eval: floor(x + ½) clamped; train: x + the same U(-½, ½) draw,
    clamped."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4, 5, 6)) * 100).astype(np.float32)
    np.testing.assert_array_equal(
        noise_quant(torch.from_numpy(x), training=False).numpy(),
        np.asarray(jnoise_quant(jnp.asarray(x), training=False)))
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -0.5, 0.5))
    got = noise_quant(torch.from_numpy(x), training=True,
                      noise_fn=lambda shape, dtype, device: torch.from_numpy(u))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnoise_quant(jnp.asarray(x), key=key, training=True)))


# --------------------------------------------------- (b) kernel backwards


@pytest.mark.parametrize("c,inverse", [(16, False), (16, True), (32, False), (32, True)])
def test_gdn_plain_backward_matches_closed_form(c, inverse):
    """``gdn_plain_backward`` against ``_gdn_fused_bwd``, and ``gdn_fused``'s
    autograd.Function against ``jax.vjp`` of the Pallas op (interpret)."""
    rng = np.random.default_rng(c + inverse)
    x = rng.standard_normal((300, c)).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    g = rng.standard_normal((300, c)).astype(np.float32)
    ref = _gdn_fused_bwd(inverse, True, tuple(map(jnp.asarray, (x, gamma, beta))),
                         jnp.asarray(g))
    got = tgdn.gdn_plain_backward(*map(torch.from_numpy, (g, x, gamma, beta)), inverse)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    _, vjp = jax.vjp(lambda a, gm, bt: jgdn_fused(a, gm, bt, inverse, True),
                     *map(jnp.asarray, (x, gamma, beta)))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, gamma, beta)]
    before = tgdn.gdn_fused.backwards
    tgdn.gdn_fused(*ts, inverse).backward(torch.from_numpy(g))
    assert tgdn.gdn_fused.backwards == before + 1
    for t, b in zip(ts, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def _module_vjp_case(jmod, tmod, x, fwd_kwargs=None):
    """jax.vjp of the JAX module (params and input) against autograd of the
    port module whose parameters come from the same flax tree; a random
    cotangent.  → (port grads, JAX grads), flax keys, the input as 'x'."""
    params = jax.tree.map(np.array, jmod.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"])
    rng = np.random.default_rng(8)
    # wake the zero-init output weights, so that every branch has a gradient
    params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32) if not a.any() else a,
        params)
    tmod.load_state_dict(state_from_flax(params, tmod))
    y, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a), params, jnp.asarray(x))
    g = rng.standard_normal(y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(g))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    yt = tmod(xt, **(fwd_kwargs or {}))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), atol=1e-4, rtol=1e-4)
    yt.backward(_nchw(g).contiguous(memory_format=torch.channels_last))
    got = _port_grads(tmod)
    got["x"] = _nhwc(xt.grad)
    ref = _flat(gp)
    ref["x"] = np.asarray(gx)
    return got, ref


def test_b3_conv5s2_backward_matches_jax_vjp():
    """The B3 slot (k 5, stride 2, pad (1, 2, 1, 2), C_in 192)."""
    x = np.random.default_rng(9).standard_normal((2, 8, 12, 192)).astype(np.float32)
    tmod = Conv2d(192, 160, 5, 2, (1, 2, 1, 2))
    assert tmod.kernel_slot(_nchw(x)) == "conv5s2"
    before = conv_direct.conv5s2.backwards
    got, ref = _module_vjp_case(jconv.Conv2d(160, kernel_size=5, stride=2, padding=(1, 2, 1, 2)),
                                tmod, x)
    assert conv_direct.conv5s2.backwards == before + 1
    _assert_grads_close(got, ref, 1e-4)


@pytest.mark.parametrize("k", [3, 7])
def test_b6_convk_s1_backward_matches_jax_vjp(k):
    """The B6 slot: a plain k×k conv, and a ``ResidualBlock`` (bias +
    LeakyReLU, then the residual, in the epilogue)."""
    x = np.random.default_rng(10 + k).standard_normal((2, 6, 10, 192)).astype(np.float32)
    before = conv_direct.convk_s1.backwards
    got, ref = _module_vjp_case(jconv.Conv2d(176, kernel_size=k, padding=k // 2),
                                Conv2d(192, 176, k, 1, k // 2), x)
    _assert_grads_close(got, ref, 1e-4)
    got, ref = _module_vjp_case(JResidualBlock(192), ResidualBlock(192), x)
    _assert_grads_close(got, ref, 1e-4)
    assert conv_direct.convk_s1.backwards == before + 3


@pytest.mark.parametrize("fuse", [False, True])
def test_b4_b5_window_attention_backward_matches_jax_vjp(fuse):
    """``WinBasedAttention`` (C 192, 8 heads, ws 8, shift 4, a padded map):
    B4 between the Linears, or B5 with ``fuse_proj``."""
    x = np.random.default_rng(11).standard_normal((2, 14, 20, 192)).astype(np.float32)
    tmod = WinBasedAttention(192, 8, 8, 4)
    tmod.attn.fuse_proj = fuse
    counter = window_attn.window_attention_proj if fuse else window_attn.window_attention
    before = counter.backwards
    got, ref = _module_vjp_case(JWinBasedAttention(192, 8, 8, 4), tmod, x)
    assert counter.backwards == before + 1
    _assert_grads_close(got, ref, 1e-4)


# ----------------------------------------- (c) the training forward + grads


@pytest.fixture(scope="module")
def jax_training_run():
    """One JAX training loss + gradient of ``source_net`` (n_override 32,
    B 2, 64×64), its five noise draws recorded by wrapping
    ``jax.random.uniform``."""
    cfg = jget_config("source_net", n_override=32)
    jm = JCodecModel(cfg)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    params = init_params(jm)
    tc = JTrainConfig()
    draws = []
    orig = jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": jax.random.PRNGKey(5)})
        loss = jloss.rate_distortion_loss(out.bpp, out.mse, tc.lmbda)
        aux = jm.apply({"params": p}, method=JCodecModel.entropy_aux_loss)
        return loss + aux, (loss, out.bpp, out.mse, aux)

    jax.random.uniform = recording
    try:
        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
    return params, x, draws, [float(m) for m in metrics], _flat(grads)


def test_training_forward_and_gradients_match_jax(jax_training_run):
    params, x, draws, (loss_j, bpp_j, mse_j, aux_j), grads_j = jax_training_run
    assert len(draws) == 5, [d.shape for d in draws]
    tm = build_model("source_net", device="cpu", n_override=32).train()
    tm.load_state_dict(params_from_flax(params))
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        a = a.transpose(0, 3, 1, 2) if a.ndim == 4 else a  # the slices' NHWC → NCHW
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    out = tm(_nchw(x).contiguous(memory_format=torch.channels_last), training=True,
             noise_fn=noise_fn)
    loss = tloss.rate_distortion_loss(out.bpp, out.mse, TrainConfig().lmbda)
    aux = tm.entropy_aux_loss()
    (loss + aux).backward()
    assert next(replay, None) is None
    got = [float(v) for v in (loss, out.bpp, out.mse, aux)]
    np.testing.assert_allclose(got, [loss_j, bpp_j, mse_j, aux_j], rtol=1e-5)
    ref = {k: v for k, v in grads_j.items() if not k.startswith(SKIPPED_PREFIX)}
    _assert_grads_close(_port_grads(tm), ref, 1e-4, floor=1e-7)
    # the quantiles take their gradient from the aux loss alone
    eb = tm.entropy_bottleneck
    assert all(getattr(eb, f"matrix_{i}").grad is not None for i in range(5))


def test_training_forward_needs_noise_and_rejects_stop_base_grad():
    # stop_base_grad cuts the gradient at the HAN input: the distortion's
    # gradient reaches the HAN tail and no base leaf
    pp = build_model("source_net", device="cpu", n_override=32, post_processing=True)
    xr = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 3, 64, 64))
                          .astype(np.float32))
    pp(xr, training=True, noise_fn=uniform_noise(torch.Generator().manual_seed(1)),
       stop_base_grad=True).mse.backward()
    for name, p in pp.named_parameters():
        tail = name.split(".")[0] in ("han", "conv_weights_gen_han")
        assert tail or p.grad is None, name
    assert pp.han.head.weight.grad.abs().max() > 0
    assert pp.conv_weights_gen_han.fc2.bias.grad.abs().max() > 0
    tm = build_model("source_net", device="cpu", n_override=32)
    x = torch.zeros(1, 3, 64, 64)
    # the noise comes from the noise_fn given: the same generator state,
    # the same draws
    draw = lambda: uniform_noise(torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = tm(x, training=True, noise_fn=draw()).bpp
        b = tm(x, training=True, noise_fn=draw()).bpp
    assert float(a) == float(b)


# ------------------------------------------------------- (d) the optimizer


class _Tiny(torch.nn.Module):
    def __init__(self, w, b, q):
        super().__init__()
        self.a = torch.nn.Module()
        self.a.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.a.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))
        self.eb = torch.nn.Module()
        self.eb.quantiles = torch.nn.Parameter(torch.from_numpy(q.copy()))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_matches_jax_make_optimizer(weight_decay):
    """Clip on the main group only (norm 5 and 0.5 steps), the quantiles at
    aux_lr unclipped, a MultiStep boundary at step 2, and non-finite
    gradients (a NaN at step 3, a -inf in the aux group at step 4) whose
    steps are skipped with every state kept."""
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((6, 5)) * 1e-2).astype(np.float32)
    b = (rng.standard_normal(5) * 1e-2).astype(np.float32)
    q = (rng.standard_normal((4, 1, 3)) * 1e-2).astype(np.float32)
    kw = dict(lr=1e-2, aux_lr=1e-3, lr_milestones=(1,), lr_gamma=0.5,
              weight_decay=weight_decay)
    jopt = jmake_optimizer(JTrainConfig(**kw), steps_per_epoch=2)
    jparams = {"a": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
               "eb": {"quantiles": jnp.asarray(q)}}
    jstate = jopt.init(jparams)
    model = _Tiny(w, b, q)
    assert aux_labels(model) == {"a.weight": "main", "a.bias": "main", "eb.quantiles": "aux"}
    opt = make_optimizer(model, TrainConfig(**kw), steps_per_epoch=2)
    assert isinstance(opt, CodecOptimizer)
    biggest = 0.0
    for step in range(6):
        gw, gb, gq = (rng.standard_normal(a.shape).astype(np.float32) for a in (w, b, q))
        main_norm = np.sqrt((gw ** 2).sum() + (gb ** 2).sum())
        scale = np.float32((5.0 if step % 2 == 0 else 0.5) / main_norm)
        gw, gb, gq = gw * scale, gb * scale, gq * 7.0
        if step == 3:
            gw[0, 0] = np.nan
        if step == 4:
            gq[0, 0, 2] = -np.inf
        jgrads = {"a": {"weight": jnp.asarray(gw), "bias": jnp.asarray(gb)},
                  "eb": {"quantiles": jnp.asarray(gq)}}
        finite = all(np.isfinite(a).all() for a in (gw, gb, gq))
        if finite:  # the JAX train_step's guard: keep params and state
            updates, jstate = jopt.update(jgrads, jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        for p, gnp in zip((model.a.weight, model.a.bias, model.eb.quantiles), (gw, gb, gq)):
            p.grad = torch.from_numpy(gnp.copy())
        assert opt.step_if_finite() == finite
        ref = {"w": np.asarray(jparams["a"]["weight"]), "b": np.asarray(jparams["a"]["bias"]),
               "q": np.asarray(jparams["eb"]["quantiles"])}
        biggest = max(biggest, *(float(np.abs(ref[k] - a).max()) for k, a in
                                 (("w", w), ("b", b), ("q", q))))
        got = {"w": model.a.weight, "b": model.a.bias, "q": model.eb.quantiles}
        for k in ref:
            err = float(np.abs(got[k].detach().numpy() - ref[k]).max())
            assert err <= 1e-6 * biggest, f"step {step} {k}: {err:.3g} vs {biggest:.3g}"
    assert opt.count == 4


# --------------------------------------------- (e) schedules, MS-SSIM, loss


def test_schedules_match_jax():
    cases = [
        (jschedule.multistep(1e-4, (2, 5), 10, 0.5), tschedule.multistep(1e-4, (2, 5), 10, 0.5)),
        (jschedule.warmup_cosine(1e-3, 100, 10, 1e-5), tschedule.warmup_cosine(1e-3, 100, 10, 1e-5)),
        (jschedule.warmup_cosine(1e-3, 100, 0), tschedule.warmup_cosine(1e-3, 100, 0)),
        (jschedule.warmup_stagedecay(1e-3, (30, 60), 0.1, 10),
         tschedule.warmup_stagedecay(1e-3, (30, 60), 0.1, 10)),
        (jschedule.warmup_stagedecay(1e-3, (30,), 0.1), tschedule.warmup_stagedecay(1e-3, (30,), 0.1)),
        (jschedule.warmup_linear(1e-3, 100, 10), tschedule.warmup_linear(1e-3, 100, 10)),
        (jschedule.warmup_linear(1e-3, 100), tschedule.warmup_linear(1e-3, 100)),
    ]
    steps = [0, 1, 5, 9, 10, 11, 19, 20, 29, 30, 49, 50, 60, 99, 100, 150]
    for js, ts in cases:
        np.testing.assert_allclose([ts(s) for s in steps], [float(js(s)) for s in steps],
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("size", [64, 200])
def test_ssim_ms_ssim_and_rd_loss_match_jax(size):
    """64: three scales (renormalized weights); 200: all five."""
    rng = np.random.default_rng(size)
    a = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    ta, tb = _nchw(a), _nchw(b)
    np.testing.assert_allclose(float(tloss.ssim(ta, tb, 2.0)),
                               float(jloss.ssim(jnp.asarray(a), jnp.asarray(b), 2.0)), rtol=1e-5)
    ms_t = tloss.ms_ssim(ta, tb, data_range=2.0)
    ms_j = jloss.ms_ssim(jnp.asarray(a), jnp.asarray(b), data_range=2.0)
    np.testing.assert_allclose(float(ms_t), float(ms_j), rtol=1e-5)
    np.testing.assert_allclose(float(tloss.msssim_db(ms_t)), float(jloss.msssim_db(ms_j)),
                               rtol=1e-5)
    bpp, mse = np.float32(0.4), np.float32(0.01)
    for kind, msv in (("mse", None), ("msssim", ms_j)):
        ref = jloss.rate_distortion_loss(jnp.asarray(bpp), jnp.asarray(mse), 0.0067, kind, msv)
        got = tloss.rate_distortion_loss(torch.tensor(bpp), torch.tensor(mse), 0.0067, kind,
                                         None if msv is None else ms_t)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# ------------------------------------------------------------ (h) DDP, gloo


def test_ddp_two_gloo_processes_match_single_process_gradient():
    """``tools.ddp_check``: two gloo processes, each on half the batch and
    its share of the noise, DDP-averaged, against one process on the whole
    batch."""
    from lic_tpu_torch.tools import ddp_check

    args = argparse.Namespace(world=2, preset="source_net", batch=4, size=64, device="cpu",
                              n_override=32, tol=1e-5, timeout=300.0)
    report = ddp_check.run(args)
    assert report["backend"] == "gloo" and len(report["rank_backward_ms"]) == 2
    assert report["max_share_of_range"] <= 1e-5, report["by_module"]


# ------------------------------------------- the B3/B6 weight-split cache


class _DataWriteSGD(torch.optim.Optimizer):
    """Writes through ``.data``, as a fused optimizer's kernel does: the
    version counter stays where it was."""

    def __init__(self, params, lr):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                p.data.add_(p.grad, alpha=-group["lr"])


@pytest.mark.parametrize("opt", ["data_write", "trainer"])
def test_weight_split_dropped_after_any_optimizer_step(opt):
    """``prepacked`` keys its cache on the version counter; an optimizer
    step over the weight drops the cache even where the counter does not
    move, so the next B3/B6 call packs the new weight."""
    w = torch.nn.Parameter(torch.randn(8, 4, 3, 3, generator=torch.Generator().manual_seed(6)))
    conv_direct.prepacked(w)  # the first split registers the step hook
    version = w._version
    optimizer = (_DataWriteSGD([w], 0.5) if opt == "data_write"
                 else make_optimizer(torch.nn.ParameterList([w]), TrainConfig(lr=0.1), 10))
    w.grad = torch.ones_like(w)
    optimizer.step()
    if opt == "data_write":
        assert w._version == version
    hi, lo = conv_direct.prepacked(w)
    want = conv_direct.pack_weight(w)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
