"""Port parity, small pieces: presets, ops, padding, convs, entropy models.

The same numpy inputs (fixed seeds) go through the JAX package and
``lic_tpu_torch``; JAX runs on the CPU at highest matmul precision
(``tests/conftest.py``).  Tolerances are stated per test.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu import ops as jops
from lic_tpu.data import pad as jpad
from lic_tpu.entropy import EntropyBottleneck as JEB
from lic_tpu.entropy import GaussianConditional as JGC
from lic_tpu.entropy import GaussianModel as JGM
from lic_tpu.layers.conv import Conv2d as JConv2d
from lic_tpu.layers.conv import ConvTranspose2d as JConvT
from lic_tpu.models.presets import PRESETS as JPRESETS
from lic_tpu_torch import ops as tops
from lic_tpu_torch.data import pad as tpad
from lic_tpu_torch.entropy import EntropyBottleneck, GaussianConditional, GaussianModel
from lic_tpu_torch.layers import Conv2d, ConvTranspose2d, gelu
from lic_tpu_torch.models import PRESETS, build_model
from lic_tpu_torch.models.presets import NOT_YET_PORTED
from lic_tpu_torch.utils.params import params_from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- presets


def test_source_net_row_equals_jax_preset():
    assert PRESETS["source_net"] == JPRESETS["source_net"]


def test_other_presets_raise_naming_roadmap_item():
    assert set(NOT_YET_PORTED) | set(PRESETS) == set(JPRESETS)
    for name, item in NOT_YET_PORTED.items():
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            build_model(name)


def test_import_leaves_jax_unloaded():
    code = (
        "import sys; import lic_tpu_torch, lic_tpu_torch.models.compress, "
        "lic_tpu_torch.utils.params, lic_tpu_torch.tools.profile_path, "
        "lic_tpu_torch.tools.deconv_probe; "
        "bad = [m for m in ('jax', 'flax') if m in sys.modules]; "
        "sys.exit(f'imported {bad}' if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr + r.stdout


# -------------------------------------------------------------------- ops


def test_ops_match_exactly():
    """fp32 forward values are bit-exact (both frameworks round half to
    even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, 0.0, 3.5, -2.5]  # ties
    off = rng.standard_normal(4096).astype(np.float32)
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    pairs = [
        (jops.lower_bound(jnp.asarray(x), 0.3), tops.lower_bound(xt, 0.3)),
        (jops.upper_bound(jnp.asarray(x), -0.2), tops.upper_bound(xt, -0.2)),
        (jops.ste_round(jnp.asarray(x)), tops.ste_round(xt)),
        (jops.bypass_round(jnp.asarray(x)), tops.bypass_round(xt)),
        (
            jops.quantize_ste_offset(jnp.asarray(x), jnp.asarray(off)),
            tops.quantize_ste_offset(xt, ot),
        ),
    ]
    for jp in (jops.NonNegativeParametrizer(), jops.NonNegativeParametrizer(1e-6)):
        tp = tops.NonNegativeParametrizer(jp.minimum, jp.reparam_offset)
        pairs.append((jp.init(jnp.asarray(x)), tp.init(xt)))
        pairs.append((jp(jnp.asarray(x)), tp(xt)))
    for j, t in pairs:
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("hw", [(64, 64), (100, 90)])
def test_pad_matches(hw):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, hw[0], hw[1], 3)).astype(np.float32)
    assert tpad.padded_size(*hw) == jpad.padded_size(*hw)
    yj, sj = jpad.pad_to_multiple(jnp.asarray(x), 64)
    yt, st = tpad.pad_to_multiple(_nchw(x), 64)
    assert sj == st
    np.testing.assert_array_equal(np.asarray(yj), _nhwc(yt))
    np.testing.assert_array_equal(
        np.asarray(jpad.unpad(yj, sj)), _nhwc(tpad.unpad(yt, st))
    )


# ------------------------------------------------------------------ convs


def _flax_init(module, x, seed=0, **kw):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    return jax.tree.map(np.array, v["params"])


@pytest.mark.parametrize(
    "k,stride,padding",
    [(5, 2, (1, 2, 1, 2)), (3, 1, 1), (5, 2, 2), (1, 1, 0), (3, 2, 1)],
)
def test_conv2d_matches(k, stride, padding):
    """atol 1e-5: the same fp32 sums in another order."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    jm = JConv2d(12, kernel_size=k, stride=stride, padding=padding)
    p = _flax_init(jm, x)
    p["bias"] = rng.standard_normal(12).astype(np.float32)
    yj = jm.apply({"params": p}, jnp.asarray(x))
    tm = Conv2d(8, 12, k, stride, padding)
    tm.load_state_dict({
        "weight": torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(p["bias"]),
    })
    with torch.no_grad():
        yt = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("padding,output_padding,prepad", [(3, 1, True), (2, 1, False)])
def test_conv_transpose_matches(padding, output_padding, prepad):
    """The _Up5 (pre-pad + p3) and hyper-synthesis (p2) deconvs; atol 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    if prepad:
        x = np.pad(x, ((0, 0), (1, 0), (1, 0), (0, 0)))
    jm = JConvT(6, 5, 2, padding, output_padding)
    p = _flax_init(jm, x)
    yj = jm.apply({"params": p}, jnp.asarray(x))
    tm = ConvTranspose2d(8, 6, 5, 2, padding, output_padding)
    w_t = p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy()
    tm.load_state_dict({
        "weight": torch.from_numpy(w_t), "bias": torch.from_numpy(p["bias"]),
    })
    with torch.no_grad():
        yt = tm(_nchw(x))
    assert yt.shape[2:] == np.asarray(yj).shape[1:3]
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), atol=1e-5, rtol=1e-5)


def test_gelu_is_the_erf_form():
    from lic_tpu.layers.blocks import gelu as jgelu

    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(
        gelu(torch.from_numpy(x)).numpy(), np.asarray(jgelu(jnp.asarray(x))),
        atol=1e-6, rtol=1e-6,
    )


def test_init_statistics_mirror_jax():
    """Random-init parity is statistical: the port's LeCun truncated-normal
    conv init has the JAX init's std and bounds (2 std) per layer."""
    m = build_model("source_net", seed=0)
    w = m.g_a.down1.weight.detach()
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = w.std().item()
    assert abs(std - (1 / fan_in) ** 0.5) < 0.02 * (1 / fan_in) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / fan_in) ** 0.5 / 0.8796256610342398 + 1e-6
    head = m.conv_weights_gen.fc2
    assert abs(head.bias.detach().std().item() - 0.2) < 0.05
    assert m.g_a.down0.weight.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------- entropy


def test_gaussian_models_match():
    """atol 1e-6 on likelihoods in (0, 1]: erf/erfc differ in the last
    bits between the frameworks."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 8, 6, 5)) * 4).astype(np.float32)
    mu = rng.standard_normal(x.shape).astype(np.float32)
    sig = np.exp(rng.uniform(-4, 3, x.shape)).astype(np.float32)
    xt, mt, st = map(torch.from_numpy, (x, mu, sig))
    oj, lj = JGC()(jnp.asarray(x), jnp.asarray(sig), jnp.asarray(mu), training=False)
    ot, lt = GaussianConditional()(xt, st, mt)
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6, rtol=1e-5)
    gj = JGM(1e-8)(jnp.asarray(x), jnp.asarray(sig), jnp.asarray(mu))
    gt = GaussianModel()(xt, st, mt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6, rtol=1e-5)


def test_entropy_bottleneck_matches():
    """Likelihood, medians and pmf table; atol 1e-6 (sigmoid/softplus
    last-bit differences), outputs exact."""
    rng = np.random.default_rng(5)
    c = 6
    x = (rng.standard_normal((2, 5, 4, c)) * 3).astype(np.float32)
    jm = JEB(c)
    p = _flax_init(jm, x, training=False)
    # move every parameter off its init so each term matters
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    oj, lj = jm.apply({"params": p}, jnp.asarray(x), training=False)
    pmf_j = jm.apply({"params": p}, -8, 7, method=JEB.pmf_table)
    tm = EntropyBottleneck(c)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        ot, lt = tm(_nchw(x))
        pmf_t = tm.pmf_table(-8, 7)
    np.testing.assert_array_equal(_nhwc(ot), np.asarray(oj))
    np.testing.assert_allclose(_nhwc(lt), np.asarray(lj), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(pmf_t.numpy(), np.asarray(pmf_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(tm.medians.detach().numpy(), p["quantiles"][:, 0, 1])


def test_entropy_bottleneck_init_matches_jax():
    """Deterministic inits (matrices, factors, quantiles) equal the JAX
    module's; the uniform biases share its range."""
    jm = JEB(4)
    p = _flax_init(jm, np.zeros((1, 2, 2, 4), np.float32), training=False)
    tm = EntropyBottleneck(4, generator=torch.Generator().manual_seed(0))
    for k, v in tm.state_dict().items():
        if k.startswith("bias_"):
            assert v.abs().max() <= 0.5
        else:
            np.testing.assert_allclose(v.numpy(), p[k], rtol=1e-6)


def test_params_bridge_rejects_unknown_leaves():
    tree = {"g_a": {"down0": {"kernel": np.zeros((5, 5, 3, 192), np.float32)}}}
    with pytest.raises(KeyError):
        params_from_flax(tree)
