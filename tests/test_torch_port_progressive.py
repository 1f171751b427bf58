"""Port parity of the trit-plane progressive coder (``coding/tritplane.py``,
``models/progressive.py``, the codec CLI's ``--progressive``) against
the JAX package on the CPU.

Weights: the port's seeded ``source_net`` at ``n_override=32``, its
entropy bottleneck's all-zero ``factor_i`` woken (as a trained
checkpoint has them) and g_a's last conv scaled by 12, so that the
residuals span several trit planes per slice; carried to the JAX package
by ``utils.params``.  Images from numpy seeds, 64×64 and 50×70 (padded
to 64×128).  Tolerances, fixed before the first run:

* ``num_planes_for``, balanced ternary both ways, ``TritPlaneCoder`` and
  ``GaussianTritCoder`` blobs, decodes and context rows, the
  ``GaussianTritCoder`` CDF rows, the diff/rank coding: exact; a
  truncated plane blob raises at the final-state check, as the JAX
  coder does;
* ``.ltcp`` bytes equal to ``lic_tpu.models.progressive.ProgressiveCoder``'s
  for both digit models and both sizes; each package decodes the other's
  file at every truncation point within 1e-4;
* the cases of ``tests/test_progressive.py``: every truncation point
  decodes to a finite image of the input's shape, the full decode within
  1e-4 of the eval forward (the coder's passes are the forward's on the
  CPU), more planes no worse than none (1% slack, on the init weights
  as there), bad magic, a
  non-decodable hyper, a digit-model mismatch, the σ-modelled digits
  beating the static tables on N(0, σ) residuals;
* the codec CLI: ``--progressive`` writes the JAX coder's bytes for a
  PNG, ``--truncate_planes`` decodes the prefix ``decompress`` decodes, a
  directory input raises ``ValueError``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.coding import tritplane as jtrit
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.models.progressive import ProgressiveCoder as JProgressiveCoder
from lic_tpu_torch.coding import tritplane as ttrit
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.progressive import ProgressiveCoder
from lic_tpu_torch.utils.params import flax_from_state

torch.set_num_threads(2)

N = 32
ATOL = 1e-4
NAME = "source_net"
SIZES = ((64, 64), (50, 70))
DIGITS = ("gaussian", "static")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)


def _tree(module):
    out = {}
    for key, a in flax_from_state(module).items():
        d = out
        *parents, leaf = key.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = a
    return out


@pytest.fixture(scope="module")
def models():
    tm = build_model(NAME, device="cpu", n_override=N)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in tm.entropy_bottleneck.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
        tm.g_a.down3.weight.mul_(12.0)
    return JCodecModel(jget_config(NAME, n_override=N)), _tree(tm), tm


@pytest.fixture(scope="module")
def coders(models):
    jm, params, tm = models
    return {dm: (JProgressiveCoder(jm, params, name=NAME, digit_model=dm),
                 ProgressiveCoder(tm, name=NAME, digit_model=dm)) for dm in DIGITS}


@pytest.fixture(scope="module")
def streams(coders):
    """(digit model, size) → (JAX bytes, port bytes, image)."""
    out = {}
    for dm, (jc, tc) in coders.items():
        for i, (h, w) in enumerate(SIZES):
            x = _image(h, w, 20 + i)
            out[dm, (h, w)] = (jc.compress(jnp.asarray(x)), tc.compress(_nchw(x)), x)
    return out


# ---------------------------------------------------------- trit planes

def test_planes_and_ternary_match_jax():
    for m in (0, 1, 2, 4, 5, 13, 14, 40, 41, 1000, 32000):
        assert ttrit.num_planes_for(m) == jtrit.num_planes_for(m)
    s = np.random.default_rng(0).integers(-121, 122, 5000)
    d = ttrit.to_balanced_ternary(s, 5)
    np.testing.assert_array_equal(d, jtrit.to_balanced_ternary(s, 5))
    np.testing.assert_array_equal(ttrit.from_balanced_ternary(d), s)
    with pytest.raises(AssertionError):
        ttrit.to_balanced_ternary(np.array([122]), 5)


def test_plane_coders_match_jax():
    rng = np.random.default_rng(1)
    n = 6000
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(8.0), n))
    r = np.round(rng.standard_normal(n) * sigma).astype(np.int64)
    k = ttrit.num_planes_for(int(np.abs(r).max(initial=1)))
    tg, jg = ttrit.GaussianTritCoder(), jtrit.GaussianTritCoder()
    np.testing.assert_array_equal(tg.cdfs, jg.cdfs)
    c = rng.integers(-40, 41, n).astype(np.float64)
    for t in (1.0, 3.0, 27.0):
        for a, b in zip(tg._ctx(c, t, sigma), jg._ctx(c, t, sigma)):
            np.testing.assert_array_equal(a, b)
    tb, jb = tg.encode(r, sigma, k), jg.encode(r, sigma, k)
    assert tb == jb
    ts, js = ttrit.TritPlaneCoder().encode(r, k), jtrit.TritPlaneCoder().encode(r, k)
    assert ts == js
    for planes in range(k + 1):
        dec = tg.decode(tb[:planes], n, sigma, k)
        np.testing.assert_array_equal(dec, jg.decode(jb[:planes], n, sigma, k))
        np.testing.assert_array_equal(ttrit.TritPlaneCoder().decode(ts[:planes], n, k),
                                      jtrit.TritPlaneCoder().decode(js[:planes], n, k))
        assert np.abs(dec - r).max() <= (3 ** (k - planes) - 1) // 2
    np.testing.assert_array_equal(tg.decode(tb, n, sigma, k), r)
    # the σ-modelled digits beat the static tables on N(0, σ) residuals
    assert sum(map(len, tb)) < sum(map(len, ts))


def test_truncated_plane_blob_raises_as_jax():
    rng = np.random.default_rng(2)
    n = 4000
    sigma = np.full(n, 3.0)
    r = np.round(rng.standard_normal(n) * 3).astype(np.int64)
    k = ttrit.num_planes_for(int(np.abs(r).max()))
    for coder, args in ((ttrit.GaussianTritCoder(), (sigma,)), (ttrit.TritPlaneCoder(), ())):
        blobs = coder.encode(r, *args, k)
        cut = [b[:-3] for b in blobs]
        with pytest.raises(ValueError, match="final-state"):
            coder.decode(cut, n, *args, k)


def test_diff_and_rank_coding_match_jax():
    ch = np.random.default_rng(3).integers(0, 256, (40, 30)).astype(np.uint8)
    d = ttrit.diff_encode(ch)
    np.testing.assert_array_equal(d, jtrit.diff_encode(ch))
    np.testing.assert_array_equal(ttrit.diff_decode(d), ch)
    ranks, table = ttrit.rank_encode(d)
    jranks, jtable = jtrit.rank_encode(d)
    np.testing.assert_array_equal(ranks, jranks)
    assert table == jtable
    np.testing.assert_array_equal(ttrit.rank_decode(ranks, table), d)


# ------------------------------------------------------- .ltcp streams

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dm", DIGITS)
def test_ltcp_bytes_equal_jax(streams, dm, size):
    jb, tb, _ = streams[dm, size]
    assert tb == jb


@pytest.mark.parametrize("dm", DIGITS)
def test_each_decodes_the_others_file_at_every_point(coders, streams, dm):
    jc, tc = coders[dm]
    jb, tb, x = streams[dm, SIZES[1]]
    pts = tc.truncation_points(tb)
    assert pts == jc.truncation_points(jb)
    assert pts[-1][0] >= 8, pts  # several planes in every slice
    for n, _ in pts:
        a, b = _nhwc(tc.decompress(jb, n)), np.asarray(jc.decompress(tb, n))
        assert a.shape == x.shape
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{dm} {n} planes")


def test_every_truncation_point_decodes(coders, streams):
    _, tc = coders["gaussian"]
    _, blob, x = streams["gaussian", SIZES[0]]
    pts = tc.truncation_points(blob)
    assert pts[-1][1] == len(blob)
    for n, _ in pts:
        rec = tc.decompress(blob, max_planes=n)
        assert rec.shape == (1, 3, *x.shape[1:3]) and bool(torch.isfinite(rec).all())


@pytest.mark.parametrize("dm", DIGITS)
def test_full_decode_matches_eval_forward(models, coders, streams, dm):
    _, _, tm = models
    _, tc = coders[dm]
    for size in SIZES:
        _, blob, x = streams[dm, size]
        with torch.no_grad():
            padded = torch.nn.functional.pad(_nchw(x), (0, 128 - x.shape[2], 0, 64 - x.shape[1]),
                                             mode="replicate") if size != (64, 64) else _nchw(x)
            ref = tm(padded).x_tilde[:, :, : x.shape[1], : x.shape[2]]
        np.testing.assert_allclose(tc.decompress(blob).numpy(), ref.numpy(), atol=ATOL)


def test_more_planes_not_worse():
    """On the init weights, as ``tests/test_progressive.py`` holds it: an
    untrained g_s maps the ×12 latents of the other cases to images no
    nearer the input for being exact."""
    tc = ProgressiveCoder(build_model(NAME, device="cpu", n_override=N), name=NAME)
    xt = _nchw(_image(64, 64, 22))
    blob = tc.compress(xt)
    assert tc.truncation_points(blob)[-1][0] >= 2
    mse_none = float(torch.mean((tc.decompress(blob, 0) - xt) ** 2))
    mse_full = float(torch.mean((tc.decompress(blob) - xt) ** 2))
    assert mse_full <= mse_none * 1.01, (mse_none, mse_full)


def test_bad_magic_and_digit_model_mismatch_raise(coders, streams):
    _, tc = coders["gaussian"]
    _, ts = coders["static"]
    _, blob, _ = streams["gaussian", SIZES[0]]
    with pytest.raises(ValueError, match="magic"):
        tc.decompress(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="digit model"):
        ts.decompress(blob)
    off = 5 + len(tc.name)  # magic, name length, name: then the digest
    with pytest.raises(ValueError, match="digest"):
        tc.decompress(blob[:off] + bytes([blob[off] ^ 1]) + blob[off + 1:])


def test_rejects_non_decodable_hyper_and_other_families(models):
    _, _, tm = models
    for cfg, what in ((tm.cfg.replace(hyper="unet"), "not decodable"),
                      (tm.cfg.replace(context="entroformer"), "ChARM"),
                      (tm.cfg.replace(family="neural_syntax"), "ChARM")):
        with pytest.raises(ValueError, match=what):
            ProgressiveCoder(types.SimpleNamespace(cfg=cfg), name="x")
    with pytest.raises(ValueError, match="digit_model"):
        ProgressiveCoder(tm, name="x", digit_model="laplace")


# ------------------------------------------------------------------ CLI

def test_codec_cli_progressive(tmp_path, models, coders, monkeypatch, capsys):
    from PIL import Image

    import lic_tpu_torch.models as tmodels
    from lic_tpu_torch.cli import codec as tcli
    from lic_tpu_torch.utils.checkpoint import save_params

    _, _, tm = models
    jc, tc = coders["gaussian"]
    monkeypatch.setattr(tmodels, "build_model",
                        lambda name, **kw: build_model(name, **{**kw, "n_override": N}))
    save_params(str(tmp_path / "w.npz"), tm)
    img = np.random.default_rng(30).integers(0, 255, (64, 64, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    common = ["--weight_path", str(tmp_path / "w.npz"), "--preset", NAME, "--progressive",
              "--device", "cpu"]
    tcli.main(["compress", str(tmp_path / "a.png"), str(tmp_path / "a.ltcp"), *common])
    blob = (tmp_path / "a.ltcp").read_bytes()
    assert blob == jc.compress(jnp.asarray(img[None].astype(np.float32) / 127.5 - 1.0))
    assert "truncation points (planes → bpp)" in capsys.readouterr().out
    tcli.main(["decompress", str(tmp_path / "a.ltcp"), str(tmp_path / "a2.png"), *common,
               "--truncate_planes", "2"])
    got = np.asarray(Image.open(tmp_path / "a2.png"))
    want = np.clip((tc.decompress(blob, 2)[0].permute(1, 2, 0).numpy() + 1) * 127.5,
                   0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert "truncated to 2 planes" in capsys.readouterr().out
    with pytest.raises(ValueError, match="single files"):
        tcli.main(["compress", str(tmp_path), str(tmp_path / "out"), *common])
