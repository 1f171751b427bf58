"""Port parity of the dormant layers and the analysis tools against the JAX
package on the CPU: ``GDN1``, ``layers/haar.py``, ``layers/vit.py``,
``layers/misc.py``, ``utils/init.py`` and ``utils/analyze.py``.

Weights: the port's seeded init (every all-zero leaf woken with seeded
values, so that no branch adds exactly 0), carried to the JAX modules by
``utils.params``; inputs from numpy seeds.  Tolerances, fixed before the
first run:

* ``haar_dwt2`` and the pyramid bit-equal to JAX's (the same sums in the
  same order), ``space_to_depth`` / ``depth_to_space`` bit-equal, the
  Haar roundtrip within 1e-6 (as the JAX test holds its own);
* every module's output within 1e-5 of its largest magnitude: ``GDN1``
  and ``GSDN`` both ways, ``MaskedConv2d`` A and B, ``LinearAttention``,
  ``SpatialSelfAttention``, the ViT (``vit_latent_syntax``, every module of
  the file on the way), ``BlockTrain``, ``UnetHaHs`` and the
  ``UnetHa`` → ``UnetHs`` pair; ``MaskedConv2d``'s output at a position
  does not move when a later input (raster order) does;
* ``effective_receptive_field`` within 1e-5 of JAX's largest score,
  ``erf_heatmap`` and ``feature_map_stats`` on the same values within
  1e-6;
* ``apply_init_scheme``: per scheme, the redrawn kernels' standard
  deviation within 5% (4σ of its sampling error over ≥ 10⁵ values) of
  the scheme's own, the Xavier-uniform bound held, biases 0, norm scales
  1, every other leaf bit-identical; the same generator seed gives the
  same values, another seed other values; a transposed conv draws with
  JAX's fans of its HWIO kernel.
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.layers import GDN1 as JGDN1
from lic_tpu.layers import haar as jhaar
from lic_tpu.layers import misc as jmisc
from lic_tpu.layers import vit as jvit
from lic_tpu.utils import analyze as janalyze
from lic_tpu_torch.layers import GDN1, haar, misc, vit
from lic_tpu_torch.layers.conv import Conv2d, ConvTranspose2d, Linear
from lic_tpu_torch.models.codec import CodecModel
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.utils import analyze
from lic_tpu_torch.utils.init import SCHEMES, apply_init_scheme, trunc_normal_array
from lic_tpu_torch.utils.params import flax_leaves, to_flax_layout
from test_torch_port_unet import _close_by_range, _image, _nchw, _nhwc, _tree, _wake

TOL = 1e-5


def _pair(tm, jm, x, seed=1, **kw):
    """(port output, JAX output) of the two modules on NHWC ``x``, the
    port's weights (woken) in both."""
    tm = _wake(tm, seed)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, **kw))(_tree(tm), jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    return got, want


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------ GDN1, Haar


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_matches_jax(inverse):
    x = _image((2, 5, 6, 8), 1)
    tm = GDN1(8, inverse=inverse)
    with torch.no_grad():
        tm.gamma.add_(0.1 * torch.rand(8, 8, generator=_gen(2)))
    got, want = _pair(tm, JGDN1(8, inverse=inverse), x)
    _close_by_range(_nhwc(got), want, "GDN1", TOL)


def test_haar_matches_jax_and_roundtrips():
    x = _image((2, 16, 12, 3), 7)
    y = haar.haar_dwt2(_nchw(x))
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jhaar.haar_dwt2(jnp.asarray(x))))
    np.testing.assert_allclose(_nhwc(haar.haar_idwt2(y)), x, atol=1e-6)
    for got, want in zip(haar.haar_pyramid(_nchw(x), 2), jhaar.haar_pyramid(jnp.asarray(x), 2)):
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


# ---------------------------------------------------------------- ViT


def test_vit_latent_syntax_matches_jax():
    tm = vit.vit_latent_syntax(16, generator=_gen(3))
    got, want = _pair(tm, jvit.vit_latent_syntax(16), _image((2, 16, 16, 3), 4))
    assert got.shape == (2, 16)
    _close_by_range(got.numpy(), want, "vit_latent_syntax", TOL)


@pytest.mark.parametrize("representation_size", [None, 24])
def test_vit_pieces_match_jax(representation_size):
    """PatchEmbed, one ViTBlock (no qkv bias) and a two-block transformer
    with ``pre_logits``."""
    x = _image((1, 8, 8, 5), 5)
    got, want = _pair(vit.PatchEmbed(5, 4, 16, generator=_gen(4)), jvit.PatchEmbed(4, 16), x)
    _close_by_range(got.numpy(), want, "PatchEmbed", TOL)
    tokens = _image((2, 7, 16), 6)
    tm = _wake(vit.ViTBlock(16, 4, qkv_bias=False, generator=_gen(5)), 2)
    want = jvit.ViTBlock(4, qkv_bias=False).apply({"params": _tree(tm)}, jnp.asarray(tokens))
    with torch.no_grad():
        _close_by_range(tm(torch.from_numpy(tokens)).numpy(), want, "ViTBlock", TOL)
    tm = vit.VisionTransformer(8, 4, 16, 2, 4, num_classes=3, in_chans=5,
                               representation_size=representation_size, generator=_gen(6))
    jm = jvit.VisionTransformer(8, 4, 16, 2, 4, num_classes=3,
                                representation_size=representation_size)
    got, want = _pair(tm, jm, x)
    _close_by_range(got.numpy(), want, "VisionTransformer", TOL)


def test_vit_base_patch16_224_has_the_jax_parameter_tree():
    with torch.device("meta"):
        tm = vit.vit_base_patch16_224()
    shapes = jax.eval_shape(lambda k: jvit.vit_base_patch16_224().init(
        k, jnp.zeros((1, 224, 224, 3))), jax.random.PRNGKey(0))["params"]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {key: tuple(to_flax_layout(m, pn, torch.zeros(dict(tm.named_parameters())[sk].shape))
                      .shape) for sk, key, m, pn in flax_leaves(tm)}
    assert got == want


# ---------------------------------------------------------------- misc


@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_masked_conv_matches_jax_and_is_causal(mask_type):
    x = _image((1, 9, 9, 6), 8)
    tm = misc.MaskedConv2d(6, 4, 5, mask_type, generator=_gen(7))
    got, want = _pair(tm, jmisc.MaskedConv2d(4, 5, mask_type), x)
    _close_by_range(_nhwc(got), want, "MaskedConv2d", TOL)
    # a later input (raster order) moves nothing at (4, 4); the centre
    # itself moves the output only through mask B
    for (i, j), moves in (((4, 5), False), ((5, 0), False), ((8, 8), False),
                          ((4, 4), mask_type == "B"), ((4, 3), True)):
        x2 = x.copy()
        x2[0, i, j] += 1.0
        with torch.no_grad():
            d = (tm(_nchw(x2)) - got)[0, :, 4, 4].abs().max()
        assert (float(d) > 0) == moves, (mask_type, i, j)


@pytest.mark.parametrize("inverse", [False, True])
def test_gsdn_matches_jax(inverse):
    x = _image((2, 5, 6, 8), 9)
    tm = misc.GSDN(8, inverse=inverse)
    with torch.no_grad():
        tm.beta2.add_(0.5)
        tm.gamma2.add_(0.05 * torch.rand(8, 8, generator=_gen(8)))
    got, want = _pair(tm, jmisc.GSDN(8, inverse=inverse), x)
    _close_by_range(_nhwc(got), want, "GSDN", TOL)


def test_space_to_depth_is_the_jax_function_and_shared():
    from lic_tpu_torch.layers import entroformer

    x = _image((2, 8, 6, 3), 10)
    s = misc.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jmisc.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(misc.depth_to_space(s).numpy(), x)
    assert entroformer.space_to_depth is misc.space_to_depth
    assert entroformer.depth_to_space is misc.depth_to_space


@pytest.mark.parametrize("which", ["linear", "spatial"])
def test_attention_modules_match_jax(which):
    x = _image((2, 6, 5, 32), 11)
    if which == "linear":
        tm, jm = misc.LinearAttention(32, 4, 8, generator=_gen(9)), jmisc.LinearAttention(4, 8)
    else:
        tm, jm = misc.SpatialSelfAttention(32, generator=_gen(9)), jmisc.SpatialSelfAttention()
    got, want = _pair(tm, jm, x)
    _close_by_range(_nhwc(got), want, which, TOL)


def test_block_train_matches_jax():
    x = _image((2, 4, 4, 12), 12)
    tm = misc.BlockTrain(12, 16, 16, embed_dim=32, num_heads=4, generator=_gen(10))
    got, want = _pair(tm, jmisc.BlockTrain(16, 32, 4), x)
    assert got.shape == (2, 16, 4, 4)
    _close_by_range(_nhwc(got), want, "BlockTrain", TOL)


def test_unet_ha_hs_fused_matches_jax():
    x = _image((1, 8, 8, 64), 13)
    tm = misc.UnetHaHs(64, 48, 8, 1, generator=_gen(11))
    got, want = _pair(tm, jmisc.UnetHaHs(64, 48, 8, 1), x)
    assert got.shape == (1, 48, 8, 8)
    _close_by_range(_nhwc(got), want, "UnetHaHs", TOL)


def test_unet_ha_then_hs_match_jax():
    x = _image((1, 8, 8, 64), 14)
    ha = _wake(misc.UnetHa(64, 8, 1, generator=_gen(12)), 3)
    hs = _wake(misc.UnetHs(40, 8, 1, in_channels=64, generator=_gen(13)), 4)
    jz = jax.jit(lambda p, v: jmisc.UnetHa(64, 8, 1).apply({"params": p}, v))(
        _tree(ha), jnp.asarray(x))
    want = jax.jit(lambda p, z: jmisc.UnetHs(40, 8, 1).apply({"params": p}, *z))(_tree(hs), jz)
    with torch.no_grad():
        z = ha(_nchw(x))
        got = hs(*z)
    for t, j, what in zip(z, jz, ("z", "middle", "skip1", "inp")):
        _close_by_range(_nhwc(t), j, what, TOL)
    assert got.shape == (1, 40, 8, 8)
    _close_by_range(_nhwc(got), want, "UnetHs", TOL)


# ------------------------------------------------------------ analysis


def test_effective_receptive_field_and_heatmap_match_jax():
    x = _image((2, 16, 16, 3), 15)
    tm = torch.nn.Module()
    tm.c0 = Conv2d(3, 8, 3, 1, 1, generator=_gen(14))
    tm.c1 = Conv2d(8, 4, 5, 2, 2, generator=_gen(15))
    tm.forward = lambda v: tm.c1(torch.nn.functional.gelu(tm.c0(v)))
    p = _tree(_wake(tm, 5))

    def jfn(v):
        h = jax.lax.conv_general_dilated(v, p["c0"]["kernel"], (1, 1), [(1, 1)] * 2,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = jax.nn.gelu(h + p["c0"]["bias"], approximate=False)
        h = jax.lax.conv_general_dilated(h, p["c1"]["kernel"], (2, 2), [(2, 2)] * 2,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return h + p["c1"]["bias"]

    want = janalyze.effective_receptive_field(jfn, jnp.asarray(x))
    got = analyze.effective_receptive_field(tm, _nchw(x))
    assert got.shape == (16, 16) and (want > 0).sum() > 20
    _close_by_range(got, want, "ERF", TOL)
    np.testing.assert_allclose(analyze.erf_heatmap(got), janalyze.erf_heatmap(got), atol=1e-6)
    with torch.no_grad():
        feats = tm(_nchw(x))
    stats = analyze.feature_map_stats(feats)
    jstats = janalyze.feature_map_stats(_nhwc(feats))
    assert stats["shape"] == (2, 4, 8, 8)
    for k in ("per_channel_mean", "per_channel_std"):
        np.testing.assert_allclose(stats[k], jstats[k], atol=1e-6)
    got_d = analyze.analyze_data(feats, log_fn=lambda s: None)
    want_d = janalyze.analyze_data(_nhwc(feats), log_fn=lambda s: None)
    assert got_d["hist"] == want_d["hist"]
    np.testing.assert_allclose([got_d[k] for k in ("min", "max", "mean", "std")],
                               [want_d[k] for k in ("min", "max", "mean", "std")], atol=1e-6)


def test_feature_dumps_write_files(tmp_path, monkeypatch):
    """The maps, and the heatmaps through matplotlib alone (seaborn made
    unimportable)."""
    monkeypatch.setitem(sys.modules, "seaborn", None)
    feats = torch.from_numpy(_image((1, 5, 6, 7), 16))
    assert analyze.dump_feature_maps(feats, str(tmp_path / "m"), max_channels=3) == 3
    assert analyze.dump_feature_heatmaps(feats, str(tmp_path / "h"), max_channels=1,
                                         annot_grid=True) == 2
    assert len(list((tmp_path / "m").iterdir())) == 3
    assert len(list((tmp_path / "h").iterdir())) == 2


# --------------------------------------------------------------- init


_BASE = []


def _init_model():
    """A fresh copy of one seeded ``source_net`` at N = 64 (built once)."""
    if not _BASE:
        _BASE.append(CodecModel(PRESETS["source_net"].replace(n_override=64), generator=_gen(0)))
    return copy.deepcopy(_BASE[0])


_EXPECTED_STD = {
    "xavier_uniform": lambda fi, fo: np.sqrt(6.0 / (fi + fo)) / np.sqrt(3.0),
    "xavier_normal": lambda fi, fo: np.sqrt(2.0 / (fi + fo)),
    "kaiming_normal": lambda fi, fo: np.sqrt(2.0 / fi),
    "lecun": lambda fi, fo: np.sqrt(1.0 / fi) * 0.87962566103423978,
    "vit2": lambda fi, fo: np.sqrt(6.0 / (fi + fo)) / np.sqrt(3.0),
}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_apply_init_scheme_statistics_selectivity_and_determinism(scheme):
    base = _init_model()
    before = {k: v.clone() for k, v in base.state_dict().items()}
    m = apply_init_scheme(_init_model(), scheme, _gen(7))
    after = m.state_dict()
    redrawn = 0
    for skey, key, mod, pname in flax_leaves(m):
        leaf, p = key.rsplit("/", 1)[-1], after[skey]
        if leaf == "kernel" and p.dim() >= 2:
            flax = to_flax_layout(mod, pname, p)
            fi = flax.shape[-2] * int(np.prod(flax.shape[:-2]))
            fo = flax.shape[-1] * int(np.prod(flax.shape[:-2]))
            if flax.size >= 100_000:  # statistics on the big kernels
                assert abs(flax.std() / _EXPECTED_STD[scheme](fi, fo) - 1) < 0.05, key
                assert abs(flax.mean()) < 0.05 * flax.std(), key
                redrawn += 1
            if scheme in ("xavier_uniform", "vit2"):
                assert np.abs(flax).max() <= np.sqrt(6.0 / (fi + fo)) + 1e-7, key
            assert not torch.equal(p, before[skey]), key
        elif leaf == "bias":
            assert not p.any(), key
        else:
            assert torch.equal(p, before[skey]), key  # GDN β/Γ, the entropy models' tables
    assert redrawn >= 4
    again = apply_init_scheme(_init_model(), scheme, _gen(7)).state_dict()
    other = apply_init_scheme(_init_model(), scheme, _gen(8)).state_dict()
    assert all(torch.equal(after[k], again[k]) for k in after)
    assert not torch.equal(after["g_a.down1.weight"], other["g_a.down1.weight"])


def test_init_scheme_sets_norm_scales_and_uses_hwio_fans():
    """A LayerNorm's scale goes to 1 (its bias to 0); a transposed conv's
    (in, out, k, k) weight draws with fan_in = k·k·in, fan_out = k·k·out
    (JAX's ``_fans`` on HWIO), not torch's swapped pair."""
    m = torch.nn.Module()
    m.norm = torch.nn.LayerNorm(8)
    m.up = ConvTranspose2d(96, 24, 5, 2, 2, 1, generator=_gen(1))
    m.fc = Linear(300, 400, generator=_gen(2))
    with torch.no_grad():
        m.norm.weight.fill_(3.0)
        m.norm.bias.fill_(2.0)
    apply_init_scheme(m, "kaiming_normal", _gen(3))
    assert torch.equal(m.norm.weight, torch.ones(8)) and not m.norm.bias.any()
    std = float(m.up.weight.detach().std())
    assert abs(std / np.sqrt(2.0 / (25 * 96)) - 1) < 0.05
    assert abs(float(m.fc.weight.detach().std()) / np.sqrt(2.0 / 300) - 1) < 0.05
    with pytest.raises(ValueError, match="unknown init scheme"):
        apply_init_scheme(m, "orthogonal")


def test_trunc_normal_array_bounds_and_spread():
    x = trunc_normal_array((200_000,), std=0.02, generator=_gen(4))
    assert float(x.abs().max()) <= 2.0
    # the bounds are in pre-scale units: N(0, 1) cut at ±2, times 0.02
    assert abs(float(x.std()) / (0.87962566 * 0.02) - 1) < 0.01
    y = trunc_normal_array((200_000,), std=1.0, a=-1.0, b=1.0, generator=_gen(5))
    assert float(y.min()) >= -1.0 and float(y.max()) <= 1.0
    assert abs(float(y.std()) - 0.5377) < 0.01  # a unit normal cut at ±1
