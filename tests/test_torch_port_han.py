"""Port parity of the HAN post-processing tail (``models/han.py``) and the
model, training and evaluation around it, against the JAX package on the
CPU.

Weights: the port's seeded init (``source_net`` at ``n_override=32``,
``post_processing=True``, or the module alone), every all-zero leaf woken
with seeded values (biases, each RCAB's second conv, each group's tail,
the LAM and CSAM scales γ, the entropy bottleneck's ``factor_i``) so that
no branch adds exactly 0, carried to the JAX package by ``utils.params``
(``flax_from_state``); its tree is the JAX init's, leaf for leaf and
shape for shape (``jax.eval_shape``).  The JAX side runs op by op (no
``jit``): the HAN's compile would cost more than the whole file.  Inputs
from numpy seeds.  Tolerances, fixed before the first run:

* ``mean_shift``, CALayer, RCAB, ResidualGroup (8 blocks), LAM (5
  stages), CSAM and ``HANHead`` at ``is_high`` False and True, on 8×8
  maps: within 1e-4 of the output's largest magnitude;
* the ``post_processing`` eval forward at 64×64: x_tilde within 1e-4 of
  its largest magnitude (the untrained tail's output reaches about 20),
  bpp within 1e-5 relative, ``synthesize`` the forward's reconstruction;
  with ``use_post_processing=False`` the model without the tail, bit for
  bit;
* gradients of the decode tail (generated conv, HAN, second generated
  conv, mean shift) against ``jax.vjp`` of the JAX ``_decode_tail`` for a
  random cotangent, for its input and every parameter, within 1e-4 of
  each gradient's largest magnitude, in float64 on both sides: in fp32 a
  ReLU whose input lies within rounding of 0 takes the other branch in
  one package (each such flip moves an input gradient by about 1e-3 of its
  range at this size), which says nothing of the port;
* ``stop_base_grad``: no base leaf takes a gradient, the tail's leaves do;
* ``partition_labels`` equal to the JAX labels leaf for leaf; a phase-2
  step keeps every base leaf bit for bit with no optimizer state and moves
  every HAN leaf that took a gradient, at AdamW with optax's default
  decay; a phase-1 step keeps the tail;
* evaluation: ``evaluate_image`` scores the forward with the tail; the
  tune of a model with the tail equals, bit for bit, the tune of the same
  model without it (the JAX tune's parity is held in
  ``test_torch_port_eval.py``), and leaves the tail as it was;
* ``.npz`` files: a HAN-less base checkpoint loads non-strictly, the HAN
  keeping its init; the eval and train CLIs' ``--post_processing``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lic_tpu.models import han as jhan
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.training.train import partition_labels as jpartition_labels
from lic_tpu_torch.config import EvalConfig, TrainConfig
from lic_tpu_torch.evaluation import content_adaptive_finetune, evaluate_image
from lic_tpu_torch.models import build_model, han
from lic_tpu_torch.ops.rounding import uniform_noise
from lic_tpu_torch.training import (
    create_state,
    freeze_partition,
    make_optimizer,
    make_train_step,
    partition_labels,
)
from lic_tpu_torch.training.train import PP_WEIGHT_DECAY
from lic_tpu_torch.utils.params import flax_from_state, flax_leaves, to_flax_layout

torch.set_num_threads(2)

N = 32
ATOL = 1e-4
TAIL = ("han", "conv_weights_gen_han")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))).contiguous(
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


def _assert_close_by_range(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-7)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= ATOL * scale, (what, err, scale)


def _pp_model(seed=0):
    return _wake(build_model("source_net", device="cpu", n_override=N, post_processing=True,
                             seed=seed), seed + 5)


@pytest.fixture(scope="module")
def pp():
    tm = _pp_model()
    return JCodecModel(jget_config("source_net", n_override=N, post_processing=True)), tm


def test_tree_is_the_jax_init_tree(pp):
    jm, tm = pp
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 64, 64, 3)), training=True), jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    want = {k: v for k, v in want.items() if not k.startswith("prediction_model_syntax/")}
    got = {k: a.shape for k, a in flax_from_state(tm).items()}
    assert got == want
    assert {k.split("/")[0] for k in got if k.startswith(TAIL)} == set(TAIL)


# ------------------------------------------------------------- modules

def _module_pair(jmod, tmod, x, seed):
    """``tmod`` woken, its weights in ``jmod`` → (jax output, port output)."""
    _wake(tmod, seed)
    yj = np.asarray(jmod.apply({"params": _tree(tmod)}, jnp.asarray(x)))
    with torch.no_grad():
        yt = tmod(_nchw(x) if x.ndim == 4 else torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))))
    return yj, _nhwc(yt)


def test_mean_shift_matches_jax():
    x = _image((2, 5, 6, 3), 1)
    for sign in (-1, 1):
        np.testing.assert_allclose(_nhwc(han.mean_shift(_nchw(x), sign)),
                                   np.asarray(jhan.mean_shift(jnp.asarray(x), sign)), atol=1e-7)


@pytest.mark.parametrize("name", ["CALayer", "RCAB", "ResidualGroup", "CSAMModule",
                                  "LAMModule"])
def test_block_matches_jax(name):
    g = torch.Generator().manual_seed(2)
    jmod, tmod = {
        "CALayer": (jhan.CALayer(64, 32), han.CALayer(64, 32, generator=g)),
        "RCAB": (jhan.RCAB(64, 32), han.RCAB(64, 32, generator=g)),
        "ResidualGroup": (jhan.ResidualGroup(64, 8, 32),
                          han.ResidualGroup(64, 8, 32, generator=g)),
        "CSAMModule": (jhan.CSAMModule(), han.CSAMModule(generator=g)),
        "LAMModule": (jhan.LAMModule(), han.LAMModule()),
    }[name]
    x = _image((2, 5, 8, 8, 64) if name == "LAMModule" else (2, 8, 8, 64), 3)
    yj, yt = _module_pair(jmod, tmod, x, 4)
    _assert_close_by_range(yt, yj, name)
    flat_x = x if x.ndim == 4 else x.transpose(0, 2, 3, 1, 4).reshape(yt.shape)
    assert np.abs(yt - flat_x).max() > 1e-3  # the block is not the identity


@pytest.mark.parametrize("is_high", [False, True])
def test_han_head_matches_jax(is_high):
    x = _image((1, 8, 8, 3), 5)
    tmod = han.HANHead(is_high=is_high, generator=torch.Generator().manual_seed(6))
    assert tmod.n_resgroups == (6 if is_high else 4)
    yj, yt = _module_pair(jhan.HANHead(is_high=is_high), tmod, x, 7)
    _assert_close_by_range(yt, yj, f"HANHead is_high={is_high}")


# --------------------------------------------------------- whole model

def test_post_processing_forward_matches_jax(pp):
    jm, tm = pp
    x = _image((1, 64, 64, 3), 10)
    oj = jm.apply({"params": _tree(tm)}, jnp.asarray(x), training=False)
    base = build_model("source_net", device="cpu", n_override=N)
    base.load_state_dict({k: v for k, v in tm.state_dict().items()
                          if not k.startswith(TAIL)})
    with torch.no_grad():
        ot = tm(_nchw(x))
        _assert_close_by_range(_nhwc(ot.x_tilde), np.asarray(oj.x_tilde), "x_tilde")
        np.testing.assert_allclose(float(ot.bpp), float(oj.bpp), rtol=1e-5)
        # the coders' decodes run the tail: synthesize gives the forward's
        rec = tm.synthesize(ot.extras["y_hat"], tm.syntax_from_latent(tm.analyze(_nchw(x))))
        assert torch.equal(rec, ot.x_tilde)
        raw = tm(_nchw(x), use_post_processing=False)
        assert torch.equal(raw.x_tilde, base(_nchw(x)).x_tilde)
    assert np.abs(_nhwc(raw.x_tilde) - np.asarray(oj.x_tilde)).max() > 1e-2


def test_decode_tail_vjp_matches_jax(pp):
    """The tail's gradients for its input (g_s's output) and every
    parameter it reads, float64 on both sides (see the module docstring)."""
    jm, tm = pp
    rng = np.random.default_rng(11)
    xt = rng.standard_normal((1, 32, 32, 16))
    syn = np.round(rng.standard_normal((1, 1, 1, 16)) * 3)
    ct = rng.standard_normal((1, 32, 32, 3))
    with jax.enable_x64(True):
        params = _tree(tm, np.float64)
        _, vjp = jax.vjp(
            lambda p, v: jm.apply({"params": p}, v, jnp.asarray(syn),
                                  method=JCodecModel._decode_tail),
            params, jnp.asarray(xt))
        gp, gx = jax.tree.map(np.asarray, vjp(jnp.asarray(ct)))
    m = _pp_model().double()
    m.zero_grad()
    v = _nchw(xt).requires_grad_(True)
    m._decode_tail(v, torch.from_numpy(syn.transpose(0, 3, 1, 2).copy())).backward(_nchw(ct))
    _assert_close_by_range(_nhwc(v.grad), gx, "input")
    flat = _flat(gp)
    tparams = dict(m.named_parameters())
    read = TAIL + ("conv_weights_gen",)
    checked = 0
    for skey, key, module, pname in flax_leaves(m):
        if skey.split(".")[0] in read:
            got = to_flax_layout(module, pname, tparams[skey].grad.double())
            _assert_close_by_range(got, flat[key], key)
            checked += 1
    assert checked == sum(1 for k in flat if k.split("/")[0] in read)


def test_stop_base_grad_reaches_the_tail_only(pp):
    m = _pp_model().train()
    out = m(_nchw(_image((1, 64, 64, 3), 12)), training=True,
            noise_fn=uniform_noise(torch.Generator().manual_seed(0)), stop_base_grad=True)
    out.mse.backward()
    for name, p in m.named_parameters():
        if name.split(".")[0] in TAIL:
            assert p.grad is not None, name
        else:
            assert p.grad is None, name


# ------------------------------------------------------------ training

def test_partition_labels_match_jax(pp):
    _, tm = pp
    for phase in (False, True):
        jl = _flat(jpartition_labels(_tree(tm), phase))
        tl = partition_labels(tm, phase)
        for skey, key, _, _ in flax_leaves(tm):
            assert tl[skey] == jl[key], (phase, key)
        assert sorted(set(tl.values())) == ["freeze", "train"]


def test_phase2_step_freezes_the_base():
    tm = _pp_model().train()
    tc = TrainConfig()
    labels = freeze_partition(tm, True)
    opt = make_optimizer(tm, tc, steps_per_epoch=10, post_processing_phase=True)
    # optax.adamw's default decay, as the JAX package's phase 2 takes it
    assert PP_WEIGHT_DECAY == inspect.signature(optax.adamw).parameters["weight_decay"].default
    assert opt.main.param_groups[0]["weight_decay"] == PP_WEIGHT_DECAY
    assert opt.aux is None  # the quantiles are frozen with the base
    # the pp_milestones schedule (epochs 1200, 1350), not lr_milestones'
    assert opt.lr(1200 * 10) < opt.lr(1200 * 10 - 1)
    assert opt.lr(1500 * 10) == opt.lr(1500 * 10 - 1)
    state = create_state(tm, opt, tc.seed)
    step = make_train_step(tm, tc, opt, post_processing_phase=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x = _nchw(_image((2, 64, 64, 3), 13))
    for _ in range(2):
        metrics = step(state, x)
        assert float(metrics["skipped"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    held = {id(p) for p in opt.main_params}
    dead = 0
    for name, p in tm.named_parameters():
        if labels[name] == "freeze":
            assert torch.equal(p, before[name]), name
            assert id(p) not in held and p not in opt.main.state, name
        elif p.grad.any():
            assert not torch.equal(p, before[name]), name
        else:  # a CALayer squeeze whose ReLU is off for every image
            dead += 1
    assert dead < sum(v == "train" for v in labels.values()) // 10


def test_phase1_step_freezes_the_han():
    tm = _pp_model().train()
    tc = TrainConfig()
    labels = freeze_partition(tm, False)
    opt = make_optimizer(tm, tc, steps_per_epoch=10)
    state = create_state(tm, opt, tc.seed)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    metrics = make_train_step(tm, tc, opt)(state, _nchw(_image((1, 64, 64, 3), 14)))
    assert float(metrics["skipped"]) == 0.0
    moved = [n for n, p in tm.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(labels[n] == "train" for n in moved)
    assert any(n.startswith("g_a.") for n in moved)


# ---------------------------------------------------------- evaluation

def test_evaluate_image_scores_the_tail(pp):
    _, tm = pp
    x = _nchw(_image((1, 50, 70, 3), 15))
    r = evaluate_image(tm, x, EvalConfig())
    with torch.no_grad():
        out = tm(torch.nn.functional.pad(x, (0, 58, 0, 14), mode="replicate"))
    np.testing.assert_allclose(r["bpp"], float(out.bpp) * 64 * 128 / (50 * 70), rtol=1e-6)
    rec = torch.clamp(out.x_tilde[:, :, :50, :70], -1, 1)
    mse = float(torch.mean((torch.round((rec + 1) * 127.5) - torch.round((x + 1) * 127.5)) ** 2))
    np.testing.assert_allclose(r["mse"], mse, rtol=1e-5)


def test_tune_bypasses_the_han():
    """``content_adaptive_finetune`` of a model with the tail equals, bit
    for bit, the tune of the same model without it, and the tail never
    runs nor moves (``eval_net.py:171``; the JAX package's
    ``use_post_processing=False``)."""
    tm = _pp_model()
    base = build_model("source_net", device="cpu", n_override=N)
    base.load_state_dict({k: v for k, v in tm.state_dict().items() if not k.startswith(TAIL)})
    x = _nchw(_image((1, 64, 64, 3), 16))
    cfg = EvalConfig(tune_iters=2, tune_lr_drop_step=1)
    ran = []
    hooks = [m.han.register_forward_hook(lambda *a: ran.append(1)) for m in (tm,)]
    tuned = content_adaptive_finetune(
        tm, x, cfg, noise_fn=uniform_noise(torch.Generator().manual_seed(3)))
    for h in hooks:
        h.remove()
    tuned_base = content_adaptive_finetune(
        base, x, cfg, noise_fn=uniform_noise(torch.Generator().manual_seed(3)))
    assert not ran
    ref = tuned_base.state_dict()
    for k, v in tuned.state_dict().items():
        want = tm.state_dict()[k] if k.startswith(TAIL) else ref[k]
        assert torch.equal(v, want), k
    assert any(not torch.equal(v, tm.state_dict()[k])
               for k, v in tuned.state_dict().items() if k.startswith("g_a."))


# ------------------------------------------------------- files and CLIs

def test_base_checkpoint_warm_starts_the_tail(tmp_path, pp):
    from lic_tpu_torch.utils.checkpoint import load_params, save_params

    _, tm = pp
    base = build_model("source_net", device="cpu", n_override=N, seed=4)
    save_params(str(tmp_path / "base.npz"), base)
    fresh = build_model("source_net", device="cpu", n_override=N, post_processing=True, seed=1)
    init_tail = {k: v.clone() for k, v in fresh.state_dict().items() if k.startswith(TAIL)}
    with pytest.raises(KeyError):
        load_params(str(tmp_path / "base.npz"), fresh)
    load_params(str(tmp_path / "base.npz"), fresh, strict=False)
    for k, v in fresh.state_dict().items():
        want = init_tail[k] if k.startswith(TAIL) else base.state_dict()[k]
        assert torch.equal(v, want), k
    save_params(str(tmp_path / "pp.npz"), tm)
    again = load_params(str(tmp_path / "pp.npz"), build_model(
        "source_net", device="cpu", n_override=N, post_processing=True, seed=2))
    for k, v in again.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k


def _small_models(monkeypatch):
    import lic_tpu_torch.models as tmodels

    orig = tmodels.build_model
    monkeypatch.setattr(tmodels, "build_model",
                        lambda name, **kw: orig(name, **{**kw, "n_override": N}))


def test_eval_and_train_clis_take_post_processing(tmp_path, pp, monkeypatch, capsys):
    from PIL import Image

    from lic_tpu_torch.cli import eval as ecli, train as trcli
    from lic_tpu_torch.utils.checkpoint import load_params, save_params

    _, tm = pp
    _small_models(monkeypatch)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(17)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(data / "a.png")
    save_params(str(tmp_path / "pp.npz"), tm)
    ecli.main(["--data_path", str(data), "--weight_path", str(tmp_path / "pp.npz"),
               "--preset", "source_net", "--post_processing", "--device", "cpu"])
    x = torch.from_numpy(np.asarray(Image.open(data / "a.png"), np.float32)[None]
                         .transpose(0, 3, 1, 2) / 127.5 - 1.0)
    r = evaluate_image(tm, x.contiguous(memory_format=torch.channels_last))
    assert f"bpp={r['bpp']:.4f} psnr={r['psnr']:.2f}" in capsys.readouterr().out
    # phase 2 from a HAN-less base checkpoint: the base leaves stay
    base = build_model("source_net", device="cpu", n_override=N)
    save_params(str(tmp_path / "base.npz"), base)
    trcli.main(["--train_data_path", str(data), "--preset", "source_net",
                "--post_processing", "--weight_path", str(tmp_path / "base.npz"),
                "--batch_size", "1", "--crop_size", "64", "--epochs", "1",
                "--steps_per_epoch", "1", "--checkpoint_dir", str(tmp_path / "ck"),
                "--device", "cpu"])
    out = load_params(str(tmp_path / "ck" / "final.npz"), build_model(
        "source_net", device="cpu", n_override=N, post_processing=True, seed=3))
    for k, v in base.state_dict().items():
        assert torch.equal(out.state_dict()[k], v), k
    assert any(not torch.equal(v, tm.state_dict()[k])
               for k, v in out.state_dict().items() if k.startswith("han."))
