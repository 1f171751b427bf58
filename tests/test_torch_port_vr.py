"""Port parity of variable-rate serving's model side (``source_net_vr``)
against the JAX package, on the CPU.

``source_net_vr`` at ``n_override=32`` (M 16, K 4 gain units), weights
from the JAX package's init with every all-zero leaf woken with seeded
values (the entropy bottleneck's ``factor_i`` included, as in a trained
checkpoint), carried over by ``params_from_flax``; images of 64×64 and
50×70.  Tolerances, fixed before the first run:

* the preset row, the gain units' init (K 4 and the neutral K 1) and the
  (K, N) ``log_gain`` / ``log_inv_gain`` leaves both ways: exact;
* ``_gain_vectors`` at in-range, clipped and (B,) rates: within 1e-6;
* the eval forward at rates 0, 1.5, 3 and a (B,) rate: x_tilde within
  1e-4, bpp within 1e-5 relative; ``analyze`` / ``synthesize`` at the
  same rates within 1e-4;
* ``.ltc`` bytes equal both ways, for one image at each rate and for a
  mixed-rate batch, each decoded by the other package within 1e-4; so
  too for ``source_net`` with its EB woken (ROADMAP §C7);
* ``evaluate_image`` at rate 1.5: its metrics within 1e-4 relative; the
  tune at rate 1.5 (2 steps, JAX's noise replayed): g_a within 1e-4 of
  its largest magnitude;
* ``solve_rate_for_bpp``: the same rate within 1e-6 and the same
  estimate within 1e-4 relative; its errors and clamps;
* a multi-rate training step at k = 2 (JAX's noise replayed): the loss
  within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
  magnitude, as ``test_torch_port_training.py`` holds them; both
  ``lmbda_list`` errors in both packages;
* the CLIs: ``--rate`` and ``--target_bpp`` write the JAX coder's bytes
  at the rate the JAX CLI uses (``--target_bpp`` also in directory mode,
  each file its single-file bytes); ``cli.eval --rate`` prints the
  averages of the JAX ``evaluate_folder`` at that rate within 1e-4.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import EvalConfig as JEvalConfig, TrainConfig as JTrainConfig
from lic_tpu.evaluation import eval as jeval
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.compress import ChannelCoder as JChannelCoder
from lic_tpu.models.presets import PRESETS as JPRESETS, get_config as jget_config
from lic_tpu.serving import solve_rate_for_bpp as jsolve
from lic_tpu.training import loss as jloss
from lic_tpu.training.train import make_train_step as jmake_train_step
from lic_tpu_torch.config import EvalConfig, TrainConfig
from lic_tpu_torch.evaluation import content_adaptive_finetune, evaluate_image
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.serving import solve_rate_for_bpp
from lic_tpu_torch.training import loss as tloss
from lic_tpu_torch.training.train import (
    create_state,
    make_optimizer,
    make_train_step,
)
from lic_tpu_torch.utils.params import (
    SKIPPED_PREFIX,
    flax_from_state,
    flax_leaves,
    params_from_flax,
    to_flax_layout,
)
from jax_params import init_params, wake

torch.set_num_threads(2)

PRESET = "source_net_vr"
N = 32
ATOL = 1e-4
LMBDAS = (0.0025, 0.0067, 0.013, 0.05)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def vr():
    jm = JCodecModel(jget_config(PRESET, n_override=N))
    params = wake(init_params(jm), 3)
    tm = build_model(PRESET, device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params, PRESETS[PRESET]))
    return jm, params, tm


@pytest.fixture(scope="module")
def jfwd(vr):
    """The JAX eval forward, jitted once (the rate a traced argument)."""
    jm, params, _ = vr
    f = jax.jit(lambda p, x, r: jm.apply({"params": p}, x, training=False, rate=r))
    return lambda x, rate: f(params, jnp.asarray(x), jnp.asarray(rate, jnp.float32))


@pytest.fixture(scope="module")
def coders(vr):
    jm, params, tm = vr
    return JChannelCoder(jm, params, name=PRESET), ChannelCoder(tm, name=PRESET)


# ------------------------------------------------------ the model's gains


def test_preset_row_equals_jax():
    assert dataclasses.asdict(PRESETS[PRESET]) == dataclasses.asdict(JPRESETS[PRESET])


@pytest.mark.parametrize("k", [1, 4])
def test_gain_init_matches_jax(k):
    cfg = dict(n_override=N, gain_units=k, gain_span=3.0)
    # the gain leaves alone: setup's own params, without the submodules
    params = JCodecModel(jget_config(PRESET, **cfg)).init(
        jax.random.PRNGKey(0), 0.0, method=JCodecModel._gain_vectors)["params"]
    tm = build_model(PRESET, device="cpu", **cfg)
    np.testing.assert_array_equal(tm.log_gain.detach().numpy(), params["log_gain"])
    np.testing.assert_array_equal(tm.log_inv_gain.detach().numpy(), params["log_inv_gain"])
    assert tm.log_gain.shape == (k, N)


def test_log_gains_carried_both_ways(vr):
    _, params, tm = vr
    state = params_from_flax(params, PRESETS[PRESET])
    for key in ("log_gain", "log_inv_gain"):
        assert tuple(state[key].shape) == (4, N)
        np.testing.assert_array_equal(state[key].numpy(), params[key])
    back = flax_from_state(tm)
    for key in ("log_gain", "log_inv_gain"):
        np.testing.assert_array_equal(back[key], params[key])


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.5, 3.0, -1.0, 7.2, [0.0, 2.5, 3.0]])
def test_gain_vectors_match_jax(vr, rate):
    jm, params, tm = vr
    gj, igj = jm.apply({"params": params}, jnp.asarray(rate, jnp.float32),
                       method=JCodecModel._gain_vectors)
    with torch.no_grad():
        gt, igt = tm._gain_vectors(rate)
    if np.ndim(rate):  # JAX's (B, 1, 1, N) against the port's (B, N, 1, 1)
        gt, igt = gt[:, :, 0, 0], igt[:, :, 0, 0]
        gj, igj = gj[:, 0, 0], igj[:, 0, 0]
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(igt.numpy(), np.asarray(igj), rtol=1e-6, atol=1e-6)


RATES = [0.0, 1.5, 3.0, [0.0, 1.5, 3.0]]


@pytest.mark.parametrize("rate", RATES, ids=["r0", "r1.5", "r3", "per_image"])
def test_forward_matches_jax(vr, jfwd, rate):
    _, _, tm = vr
    x = _image((3, 64, 64, 3), 1)
    out_j = jfwd(x, rate)
    with torch.no_grad():
        out_t = tm(_nchw(x), rate=rate)
    np.testing.assert_allclose(_nhwc(out_t.x_tilde), np.asarray(out_j.x_tilde), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out_t.bpp), float(out_j.bpp), rtol=1e-5)
    np.testing.assert_allclose(float(out_t.mse), float(out_j.mse), rtol=1e-4)


@pytest.mark.parametrize("rate", RATES, ids=["r0", "r1.5", "r3", "per_image"])
def test_analyze_and_synthesize_match_jax(vr, rate):
    jm, params, tm = vr
    x = _image((3, 64, 64, 3), 2)
    r = jnp.asarray(rate, jnp.float32)
    z3_j = jm.apply({"params": params}, jnp.asarray(x), r, method=JCodecModel.analyze)
    y = np.round(np.asarray(z3_j))
    syn = np.ones((3, 1, 1, 16), np.float32)
    rec_j = jm.apply({"params": params}, jnp.asarray(y), jnp.asarray(syn), r,
                     method=JCodecModel.synthesize)
    with torch.no_grad():
        z3_t = tm.analyze(_nchw(x), rate)
        rec_t = tm.synthesize(_nchw(y), _nchw(syn), rate)
    np.testing.assert_allclose(_nhwc(z3_t), np.asarray(z3_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_nhwc(rec_t), np.asarray(rec_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("base", ["entroformer_cb", "neural_syntax"])
def test_gain_units_outside_charm_slices_raise(base):
    with pytest.raises(ValueError, match="charm slice family"):
        build_model(base, device="cpu", n_override=N, gain_units=2)
    jm = JCodecModel(jget_config(base, n_override=N, gain_units=2))
    with pytest.raises(ValueError, match="charm slice family"):
        jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                jnp.zeros((1, 64, 64, 3)), training=True)


# -------------------------------------------------------------- the coder


@pytest.mark.parametrize("rate", [0.0, 1.5, 3.0])
def test_ltc_single_image_crosses_both_ways(vr, coders, rate):
    _, _, tm = vr
    jc, tc = coders
    x = _image((1, 50, 70, 3), 4)
    blob_j = jc.compress(jnp.asarray(x), rate=rate)
    blob_t = tc.compress(_nchw(x), rate=rate)
    assert blob_t == blob_j
    rec_t = tc.decompress(blob_j)
    np.testing.assert_allclose(np.asarray(jc.decompress(blob_t)), _nhwc(rec_t), atol=ATOL, rtol=0)
    from lic_tpu_torch.data.pad import pad_to_multiple

    with torch.no_grad():
        ref = tm(pad_to_multiple(_nchw(x), 64)[0], rate=rate).x_tilde[:, :, :50, :70]
    torch.testing.assert_close(rec_t, ref, atol=ATOL, rtol=0)


def test_ltc_mixed_rate_batch_crosses_both_ways(coders):
    jc, tc = coders
    x = _image((3, 64, 64, 3), 5)
    rates = [3.0, 0.0, 1.25]
    blobs_j = jc.compress_batch(jnp.asarray(x), rates=rates)
    blobs_t = tc.compress_batch(_nchw(x), rates=rates)
    assert blobs_t == blobs_j
    # each stream is the image alone at its rate
    assert [tc.compress(_nchw(x[i : i + 1]), rate=r) for i, r in enumerate(rates)] == blobs_t
    assert [len(b) for b in blobs_t][1] < [len(b) for b in blobs_t][0]
    np.testing.assert_allclose(_nhwc(tc.decompress_batch(blobs_j)),
                               np.asarray(jc.decompress_batch(blobs_t)), atol=ATOL, rtol=0)


def test_woken_source_net_ltc_crosses_both_ways():
    """``source_net`` with its EB woken: the streams of both packages
    equal, and each decodes with the other (ROADMAP §C7)."""
    jm = JCodecModel(jget_config("source_net", n_override=N))
    params = wake(init_params(jm, 2), 4)
    assert np.any(params["entropy_bottleneck"]["factor_0"])
    tm = build_model("source_net", device="cpu", n_override=N)
    tm.load_state_dict(params_from_flax(params))
    jc, tc = JChannelCoder(jm, params, name="source_net"), ChannelCoder(tm, name="source_net")
    assert jc.digest == tc.digest
    x = _image((1, 50, 70, 3), 14)
    blob = tc.compress(_nchw(x))
    assert blob == jc.compress(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jc.decompress(blob)), _nhwc(tc.decompress(blob)),
                               atol=ATOL, rtol=0)


def test_coder_rate_rules(vr):
    _, _, tm = vr
    tc = ChannelCoder(tm, name=PRESET, rate=2.0)
    x = _nchw(_image((2, 64, 64, 3), 6))
    # the coder's rate is the default; the header carries it
    assert tc.compress(x[:1]) == tc.compress(x[:1], rate=2.0)
    assert tc.compress_batch(x) == tc.compress_batch(x, rates=[2.0, 2.0])
    with pytest.raises(ValueError, match="rates for"):
        tc.compress_batch(x, rates=[1.0])
    plain = build_model("source_net", device="cpu", n_override=N)
    with pytest.raises(ValueError, match="no gain units"):
        ChannelCoder(plain, rate=1.0)
    pc = ChannelCoder(plain)
    with pytest.raises(ValueError, match="no gain units"):
        pc.compress(x[:1], rate=1.0)
    ns = ChannelCoder(build_model("neural_syntax", device="cpu", n_override=N))
    with pytest.raises(ValueError, match="no gain units"):
        ns.compress_batch(x, rates=[0.0, 1.0])


# ---------------------------------------------------- eval and rate control


def test_evaluate_image_at_a_rate_matches_jax(vr):
    jm, params, tm = vr
    x = _image((1, 50, 70, 3), 7)
    rj = jeval.evaluate_image(jm, params, jnp.asarray(x), JEvalConfig(rate=1.5))
    rt = evaluate_image(tm, _nchw(x), EvalConfig(rate=1.5))
    r0 = evaluate_image(tm, _nchw(x), EvalConfig())
    for k in ("bpp", "psnr", "mse", "msssim"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)
    assert rt["bpp"] > r0["bpp"]


def test_tune_at_a_rate_matches_jax(vr):
    jm, params, tm = vr
    cfg = dict(tune_iters=2, tune_lr_drop_step=1, rate=1.5)
    x = _image((1, 64, 64, 3), 8)
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    jeval._tune_step_cached.cache_clear()
    jax.random.uniform = recording
    try:
        tuned_j = jax.tree.map(np.array, jeval.content_adaptive_finetune(
            jm, params, jnp.asarray(x), JEvalConfig(**cfg)))
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
        jeval._tune_step_cached.cache_clear()
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))

    tuned_t = content_adaptive_finetune(tm, _nchw(x), EvalConfig(**cfg), noise_fn=noise_fn)
    assert next(replay, None) is None
    ref = params_from_flax(tuned_j, PRESETS[PRESET])
    ga_range = max(float(v.abs().max()) for k, v in ref.items() if k.startswith("g_a."))
    for name, v in tuned_t.state_dict().items():
        if name.startswith("g_a."):
            assert float((v - ref[name]).abs().max()) <= ATOL * ga_range, name
        else:
            assert torch.equal(v, tm.state_dict()[name]), name


@pytest.mark.parametrize("share", [0.3, 0.7])
def test_solve_rate_matches_jax(vr, share):
    from lic_tpu.serving.rate_control import _bpp_forward

    jm, params, tm = vr
    x = _image((1, 64, 64, 3), 9)
    lo, hi = (float(_bpp_forward(jm)(params, jnp.asarray(x), jnp.float32(r))) for r in (0, 3))
    target = lo + share * (hi - lo)
    rate_j, est_j = jsolve(jm, params, jnp.asarray(x), target, max_iters=12)
    rate_t, est_t = solve_rate_for_bpp(tm, _nchw(x), target, max_iters=12)
    assert abs(rate_t - rate_j) <= 1e-6
    np.testing.assert_allclose(est_t, est_j, rtol=1e-4)
    assert abs(est_t - target) <= 0.02 * target


def test_solve_rate_clamps_and_errors(vr):
    _, _, tm = vr
    x = _nchw(_image((1, 50, 70, 3), 10))
    with torch.no_grad():
        from lic_tpu_torch.data.pad import pad_to_multiple

        scale = 64 * 128 / (50 * 70)
        lo = float(tm(pad_to_multiple(x)[0], rate=0.0).bpp) * scale
        hi = float(tm(pad_to_multiple(x)[0], rate=3.0).bpp) * scale
    assert solve_rate_for_bpp(tm, x, lo / 2) == (0.0, pytest.approx(lo, rel=1e-6))
    assert solve_rate_for_bpp(tm, x, hi * 2) == (3.0, pytest.approx(hi, rel=1e-6))
    with pytest.raises(ValueError, match="positive"):
        solve_rate_for_bpp(tm, x, 0.0)
    with pytest.raises(ValueError, match="one"):
        solve_rate_for_bpp(tm, torch.cat([x, x]), 1.0)
    with pytest.raises(ValueError, match="gain_units >= 2"):
        solve_rate_for_bpp(build_model("source_net", device="cpu", n_override=N), x, 1.0)


# ------------------------------------------------------ multi-rate training


def test_multi_rate_training_step_matches_jax_at_k2(vr):
    """The step's loss and gradients at unit k = 2 (λ_2, rate 2), with
    JAX's five noise draws replayed."""
    jm, params, _ = vr
    k = 2
    x = _image((2, 64, 64, 3), 11)
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": jax.random.PRNGKey(5)}, rate=jnp.float32(k))
        loss = jloss.rate_distortion_loss(out.bpp, out.mse, LMBDAS[k])
        aux = jm.apply({"params": p}, method=JCodecModel.entropy_aux_loss)
        return loss + aux, loss

    jax.random.uniform = recording
    try:
        (_, loss_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
    assert len(draws) == 5
    tm = build_model(PRESET, device="cpu", n_override=N).train()
    tm.load_state_dict(params_from_flax(params, PRESETS[PRESET]))
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))

    out = tm(_nchw(x), training=True, noise_fn=noise_fn, rate=float(k))
    loss = tloss.rate_distortion_loss(out.bpp, out.mse, LMBDAS[k])
    (loss + tm.entropy_aux_loss()).backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    ref = {k: v for k, v in _flat(grads_j).items() if not k.startswith(SKIPPED_PREFIX)}
    params_t = dict(tm.named_parameters())
    got = {key: to_flax_layout(mod, pname, params_t[skey].grad)
           for skey, key, mod, pname in flax_leaves(tm)}
    assert set(got) == set(ref) and "log_gain" in ref and "log_inv_gain" in ref
    for key, r in ref.items():
        tol = max(1e-4 * float(np.abs(r).max()), 1e-7)
        assert float(np.abs(got[key] - r).max()) <= tol, key


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_train_step_draws_units_from_its_generator(vr):
    _, params, _ = vr
    tm = build_model(PRESET, device="cpu", n_override=N).train()
    tm.load_state_dict(params_from_flax(params, PRESETS[PRESET]))
    tc = TrainConfig(lmbda_list=LMBDAS)
    opt = make_optimizer(tm, tc, steps_per_epoch=10)
    state = create_state(tm, opt, seed=4)
    step = make_train_step(tm, tc, opt)
    x = _nchw(_image((1, 64, 64, 3), 12))
    ks = [int(step(state, x)["rate"]) for _ in range(4)]
    want = torch.Generator().manual_seed(4 + 3)
    assert ks == [int(torch.randint(4, (), generator=want)) for _ in range(4)]


@pytest.mark.parametrize("preset,lmbdas,match", [
    ("source_net", (0.01, 0.02), "no gain units"),
    (PRESET, (0.01, 0.02), "2 entries for 4 gain units"),
])
def test_lmbda_list_errors_match_jax(preset, lmbdas, match):
    tm = build_model(preset, device="cpu", n_override=N)
    tc = TrainConfig(lmbda_list=lmbdas)
    with pytest.raises(ValueError, match=match):
        make_train_step(tm, tc, make_optimizer(tm, tc, steps_per_epoch=1))
    with pytest.raises(ValueError, match=match):
        jmake_train_step(JCodecModel(jget_config(preset, n_override=N)),
                         JTrainConfig(lmbda_list=lmbdas), None)


# --------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def weights(vr, tmp_path_factory):
    from lic_tpu.utils.checkpoint import save_params

    path = tmp_path_factory.mktemp("w") / "vr.npz"
    save_params(str(path), vr[1])
    return str(path)


@pytest.fixture()
def vr_preset(monkeypatch):
    import lic_tpu.models as jmodels
    import lic_tpu_torch.models as tmodels

    monkeypatch.setattr(jmodels, "build_model",
                        lambda name, **kw: JCodecModel(jget_config(PRESET, n_override=N)))
    monkeypatch.setattr(tmodels, "build_model",
                        lambda name, device="cuda", **kw: build_model(
                            PRESET, device=device, n_override=N))


def _png(path, h, w, seed):
    from PIL import Image

    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)).save(path)


@pytest.mark.parametrize("flag", [["--rate", "1.5"], ["--target_bpp", "0.4"]])
def test_codec_cli_rate_flags_write_jax_bytes(tmp_path, vr, coders, weights, vr_preset, flag):
    """The port CLI's file against the JAX coder's stream of the same PNG
    at the rate the JAX CLI would use (``--rate``, or JAX's solve for
    ``--target_bpp``); the file decodes through the port CLI."""
    from PIL import Image

    from lic_tpu_torch.cli.codec import main as tmain

    jm, params, _ = vr
    jc, _ = coders
    _png(tmp_path / "a.png", 50, 70, 13)
    common = ["--weight_path", weights, "--preset", PRESET, "--device", "cpu"]
    tmain(["compress", str(tmp_path / "a.png"), str(tmp_path / "t.ltc"), *common, *flag])
    x = jnp.asarray(np.asarray(Image.open(tmp_path / "a.png"), np.float32)[None] / 127.5 - 1.0)
    rate = (float(flag[1]) if flag[0] == "--rate"
            else jsolve(jm, params, x, float(flag[1]))[0])
    assert (tmp_path / "t.ltc").read_bytes() == jc.compress(x, rate=rate)
    tmain(["decompress", str(tmp_path / "t.ltc"), str(tmp_path / "t.png"), *common])
    assert np.asarray(Image.open(tmp_path / "t.png")).shape == (50, 70, 3)


def test_codec_cli_directory_target_bpp(tmp_path, weights, vr_preset):
    """Directory mode with ``--target_bpp``: each image at its own solved
    rate, the same bytes as that image's single-file run."""
    from lic_tpu_torch.cli.codec import main as tmain

    src = tmp_path / "in"
    src.mkdir()
    for i, name in enumerate("abc"):
        _png(src / f"{name}.png", 64, 64, 20 + i)
    common = ["--weight_path", weights, "--preset", PRESET, "--target_bpp", "0.4",
              "--device", "cpu"]
    tmain(["compress", str(src), str(tmp_path / "ltc"), *common, "--batch", "2"])
    for name in "abc":
        tmain(["compress", str(src / f"{name}.png"), str(tmp_path / f"{name}.ltc"), *common])
        assert (tmp_path / f"{name}.ltc").read_bytes() == (tmp_path / "ltc" / f"{name}.ltc").read_bytes()


def test_eval_cli_rate_matches_jax(tmp_path, vr, weights, vr_preset, capsys):
    """``cli.eval --rate``'s ``AVG:`` line against the JAX
    ``evaluate_folder`` at that rate, which the JAX CLI prints."""
    from lic_tpu_torch.cli.eval import main as tmain

    jm, params, _ = vr
    _png(tmp_path / "a.png", 64, 64, 30)
    lines_j = []
    jeval.evaluate_folder(jm, params, str(tmp_path), JEvalConfig(rate=2.5),
                          log_fn=lines_j.append)
    tmain(["--data_path", str(tmp_path), "--weight_path", weights, "--preset", PRESET,
           "--rate", "2.5", "--device", "cpu"])
    avg = [dict(re.findall(r"(bpp|psnr|msssim)=([-\d.]+)", line))
           for line in (lines_j[-1], *capsys.readouterr().out.splitlines())
           if line.startswith("AVG:")]
    assert len(avg) == 2
    for k in ("bpp", "psnr", "msssim"):
        np.testing.assert_allclose(float(avg[1][k]), float(avg[0][k]), rtol=1e-4, err_msg=k)
