"""Port parity of evaluation (ROADMAP A13) against the JAX package, on the
CPU.

The ``TINY`` config of ``tests/test_eval.py`` (``source_net``'s widths, N =
192), weights from the JAX package's own init carried over by
``params_from_flax``, images of 50×70 and 64×64.  Tolerances, fixed
before the first run:

* ``pad_to_multiple`` in each mode against ``lic_tpu.data.pad``: exact;
  an unknown mode raises ``ValueError`` in both;
* ``to_255`` / ``mse_255`` / ``psnr_255`` on values that include .5 ties:
  exact (both round half to even);
* ``evaluate_image``: bpp, mse, psnr and msssim at rtol 1e-4;
* ``content_adaptive_finetune``, 3 steps with the rate drop at step 2, with
  JAX's noise draws replayed through ``noise_fn`` (recorded by wrapping
  ``jax.random.uniform``), for both values of ``tune_loss_255sq``: g_a
  within 1e-4 of g_a's largest magnitude (fixed before the first run); and
  each g_a leaf's tuning step (tuned − checkpoint) within 1e-2 of the norm
  of JAX's step (set after the first run, which held every leaf within
  1e-4 of the leaf's own largest magnitude and failed: Adam's first step
  is about lr·sign(g), so where a gradient lies within fp32 rounding of 0
  the step's direction is not determined: at seed 5, 8 of 2,858,112 g_a
  elements move ±0.9·lr apart).  Every other parameter bit-identical to
  the model's; the model itself left as it was;
* ``evaluate_folder`` over two PNGs: the averages at rtol 1e-4 and the same
  log lines' files;
* ``EvalConfig``'s defaults equal the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import CodecConfig as JCodecConfig, EvalConfig as JEvalConfig
from lic_tpu.data.pad import pad_to_multiple as jpad_to_multiple
from lic_tpu.evaluation import eval as jeval
from lic_tpu.evaluation import metrics as jmetrics
from lic_tpu.models.codec import CodecModel as JCodecModel

from lic_tpu_torch.config import CodecConfig, EvalConfig
from lic_tpu_torch.data.pad import pad_to_multiple
from lic_tpu_torch.evaluation import (
    content_adaptive_finetune,
    evaluate_folder,
    evaluate_image,
    metrics,
)
from lic_tpu_torch.models.codec import CodecModel
from lic_tpu_torch.utils.params import params_from_flax
from jax_params import init_params

torch.set_num_threads(2)

TINY_FIELDS = dict(family="charm", transform="plain", hyper="classic_dual", swatten=False,
                   syntax="basic")
RTOL = 1e-4
# the tuning step of each g_a leaf (tuned − checkpoint) against JAX's, as a
# share of the norm of JAX's (set after the first run; see the docstring)
STEP_RTOL = 1e-2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def tiny_port_model(params):
    """The port's ``TINY`` model on the CPU holding the JAX ``params``."""
    tm = CodecModel(CodecConfig(**TINY_FIELDS)).to(memory_format=torch.channels_last).eval()
    tm.load_state_dict(params_from_flax(params))
    return tm


@pytest.fixture(scope="module")
def pair():
    jm = JCodecModel(JCodecConfig(**TINY_FIELDS))
    params = init_params(jm)
    return jm, params, tiny_port_model(params)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_eval_config_defaults_equal_jax():
    assert dataclasses.asdict(EvalConfig()) == dataclasses.asdict(JEvalConfig())


@pytest.mark.parametrize("mode", ["replicate", "ones", "zeros"])
@pytest.mark.parametrize("hw", [(50, 70), (64, 64)])
def test_pad_modes_match_jax(mode, hw):
    x = _image((2, *hw, 3), 1)
    pj, sj = jpad_to_multiple(jnp.asarray(x), 64, mode=mode)
    pt, st = pad_to_multiple(_nchw(x), 64, mode=mode)
    assert st == sj
    np.testing.assert_array_equal(_nhwc(pt), np.asarray(pj))


def test_bad_pad_mode_raises_as_in_jax():
    x = _image((1, 50, 70, 3), 2)
    with pytest.raises(ValueError):
        jpad_to_multiple(jnp.asarray(x), 64, mode="reflect")
    with pytest.raises(ValueError):
        pad_to_multiple(_nchw(x), 64, mode="reflect")


def test_metrics_match_jax_exactly_with_ties():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, (2, 16, 16, 3)).astype(np.float32)
    y = (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    # values whose 0..255 image is an exact .5 tie (k + ½ for even and odd
    # k): the fp32 neighbours of (k + ½)/127.5 − 1 that land on it
    ties = []
    for k in range(64, 96):
        t = np.float32((k + 0.5) / 127.5 - 1)
        for _ in range(8):
            d = (t + np.float32(1)) * np.float32(127.5) - np.float32(k + 0.5)
            if d == 0:
                ties.append(t)
                break
            t = np.nextafter(t, np.float32(-np.inf if d > 0 else np.inf))
    ties = np.asarray(ties, np.float32)
    assert ties.size >= 10
    x.reshape(-1)[: ties.size] = ties
    y.reshape(-1)[-ties.size :] = ties
    xt, yt = _nchw(x), _nchw(y)
    np.testing.assert_array_equal(_nhwc(metrics.to_255(yt)), np.asarray(jmetrics.to_255(y)))
    mj = jmetrics.mse_255(jnp.asarray(x), jnp.asarray(y))
    mt = metrics.mse_255(xt, yt)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(metrics.psnr_255(mt).numpy(), np.asarray(jmetrics.psnr_255(mj)))


@pytest.mark.parametrize("hw", [(50, 70), (64, 64)])
def test_evaluate_image_matches_jax(pair, hw):
    jm, params, tm = pair
    x = _image((1, *hw, 3), 4)
    rj = jeval.evaluate_image(jm, params, jnp.asarray(x))
    rt = evaluate_image(tm, _nchw(x).contiguous(memory_format=torch.channels_last))
    assert rt["pixels"] == rj["pixels"] == hw[0] * hw[1]
    for k in ("bpp", "mse", "psnr", "msssim"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)


def _jax_tune_with_draws(jm, params, x, cfg):
    """JAX's ``content_adaptive_finetune`` and its noise draws, recorded by
    wrapping ``jax.random.uniform`` (the cached step is rebuilt so that its
    trace takes the wrapper)."""
    draws, orig = [], jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
        return out

    jeval._tune_step_cached.cache_clear()
    jax.random.uniform = recording
    try:
        tuned = jax.tree.map(np.array, jeval.content_adaptive_finetune(jm, params, x, cfg))
        jax.effects_barrier()
    finally:
        jax.random.uniform = orig
        jeval._tune_step_cached.cache_clear()
    return tuned, draws


@pytest.mark.parametrize("loss_255sq", [True, False])
def test_content_adaptive_finetune_matches_jax(pair, loss_255sq):
    jm, params, tm = pair
    cfg = dict(tune_iters=3, tune_lr_drop_step=2, tune_loss_255sq=loss_255sq)
    x = _image((1, 50, 70, 3), 5)
    tuned_j, draws = _jax_tune_with_draws(jm, params, jnp.asarray(x), JEvalConfig(**cfg))
    assert len(draws) == 15, [d.shape for d in draws]  # five per step
    replay = iter(draws)

    def noise_fn(shape, dtype, device):
        a = next(replay)
        a = a.transpose(0, 3, 1, 2) if a.ndim == 4 else a  # NHWC → NCHW
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    grads_before = [p.requires_grad for p in tm.parameters()]
    tuned_t = content_adaptive_finetune(
        tm, _nchw(x).contiguous(memory_format=torch.channels_last), EvalConfig(**cfg),
        noise_fn=noise_fn)
    assert next(replay, None) is None
    # the model itself is left as it was
    after = tm.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert [p.requires_grad for p in tm.parameters()] == grads_before
    assert [p.requires_grad for p in tuned_t.parameters()] == grads_before
    ref = params_from_flax(tuned_j)
    ga_range = max(float(v.abs().max()) for k, v in ref.items() if k.startswith("g_a."))
    moved = 0
    for name, v in tuned_t.state_dict().items():
        if name.startswith("g_a."):
            err = float((v - ref[name]).abs().max())
            assert err <= RTOL * ga_range, (name, err)
            step_t, step_j = (v - before[name]).double(), (ref[name] - before[name]).double()
            off = float((step_t - step_j).norm() / step_j.norm())
            assert off <= STEP_RTOL, (name, off)
            moved += not torch.equal(v, before[name])
        else:
            assert torch.equal(v, before[name]), name
    assert moved > 0
    # JAX too keeps everything but g_a
    for key in params:
        if key != "g_a":
            for a, b in zip(jax.tree.leaves(params[key]), jax.tree.leaves(tuned_j[key])):
                np.testing.assert_array_equal(a, b)


def test_evaluate_folder_matches_jax(pair, tmp_path):
    from PIL import Image

    jm, params, tm = pair
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (50, 70)), ("b.png", (64, 64))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / name)
    lines_j, lines_t = [], []
    aj = jeval.evaluate_folder(jm, params, str(tmp_path), log_fn=lines_j.append)
    at = evaluate_folder(tm, str(tmp_path), log_fn=lines_t.append)
    assert at["images"] == aj["images"] == 2
    for k in ("bpp", "psnr", "mse", "msssim"):
        np.testing.assert_allclose(at[k], aj[k], rtol=RTOL, err_msg=k)
    assert [l.split(":")[0] for l in lines_t] == [l.split(":")[0] for l in lines_j]
    assert lines_t[-1].startswith("AVG: bpp=")
