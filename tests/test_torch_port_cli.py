"""The port's codec and eval CLIs against the JAX package's, on the CPU.

The ``TINY`` config (``source_net``'s widths) stands in for a preset in
both packages through ``monkeypatch``, as in ``tests/test_cli_codec.py``,
with the JAX package's initial weights in a ``.npz`` that both load.

* ``.ltc`` files: for the same PNG and weights both CLIs write the same
  bytes; a file written by either decodes with the other, the two
  reconstructions within one level of each other (uint8);
* directory mode at ``--batch 2`` over three same-sized images (a chunk of
  two and a remainder of one) and one other size: the file names, each
  stream the single-file bytes, each decoded PNG equal to the single-file
  decode;
* fault C5, cross-batch σ-indexes: three images encoded one at a time
  decode together, and encoded together decode one at a time, to
  bit-identical reconstructions;
* a truncated file and a wrong ``--preset`` raise ``ValueError`` (the
  ``--progressive``, ``--truncate_planes`` and ``--post_processing``
  flags are held in ``test_torch_port_progressive.py`` and
  ``test_torch_port_han.py``);
* ``cli.eval.main`` on a folder: its ``AVG:`` line's bpp, PSNR and MS-SSIM
  within 1e-4 (relative) of the JAX CLI's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import CodecConfig as JCodecConfig
from lic_tpu.models.codec import CodecModel as JCodecModel

from lic_tpu_torch.cli import codec as tcli
from lic_tpu_torch.config import CodecConfig
from lic_tpu_torch.models.codec import CodecModel
from lic_tpu_torch.models.compress import ChannelCoder
from lic_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

TINY_FIELDS = dict(family="charm", transform="plain", hyper="classic_dual", swatten=False,
                   syntax="basic")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from lic_tpu.utils.checkpoint import save_params

    model = JCodecModel(JCodecConfig(**TINY_FIELDS))
    init = jax.jit(lambda k: model.init({"params": k, "noise": jax.random.PRNGKey(1)},
                                        jnp.zeros((1, 64, 64, 3), jnp.float32), training=True))
    v = init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("w") / "tiny.npz"
    save_params(str(path), v["params"])
    return str(path)


def _port_tiny(name, device="cuda", **kw):
    return CodecModel(CodecConfig(**TINY_FIELDS)).to(
        device, memory_format=torch.channels_last).eval()


@pytest.fixture()
def tiny_preset(monkeypatch):
    import lic_tpu.models as jmodels
    import lic_tpu_torch.models as tmodels

    monkeypatch.setattr(jmodels, "build_model",
                        lambda name, **kw: JCodecModel(JCodecConfig(**TINY_FIELDS)))
    monkeypatch.setattr(tmodels, "build_model", _port_tiny)


@pytest.fixture(scope="module")
def coder(weights):
    return ChannelCoder(load_params(weights, _port_tiny("tiny", "cpu")), name="tiny")


def _write_img(path, h, w, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.int16)


def _run_jax(*argv):
    from lic_tpu.cli.codec import main

    main(list(argv))


def _run_port(*argv):
    tcli.main([*argv, "--device", "cpu"])


def test_ltc_files_cross_between_the_packages(tmp_path, weights, tiny_preset):
    src = tmp_path / "img.png"
    _write_img(src, 50, 70, 0)
    common = ["--weight_path", weights, "--preset", "tiny"]
    _run_jax("compress", str(src), str(tmp_path / "j.ltc"), *common)
    _run_port("compress", str(src), str(tmp_path / "t.ltc"), *common)
    assert (tmp_path / "j.ltc").read_bytes() == (tmp_path / "t.ltc").read_bytes()
    _run_port("decompress", str(tmp_path / "j.ltc"), str(tmp_path / "t_of_j.png"), *common)
    _run_jax("decompress", str(tmp_path / "t.ltc"), str(tmp_path / "j_of_t.png"), *common)
    t_of_j, j_of_t = _png(tmp_path / "t_of_j.png"), _png(tmp_path / "j_of_t.png")
    assert t_of_j.shape == (50, 70, 3)
    assert np.abs(j_of_t - t_of_j).max() <= 1


def test_directory_mode_with_a_remainder_chunk(tmp_path, weights, tiny_preset):
    src = tmp_path / "in"
    os.makedirs(src)
    for i, name in enumerate(("a", "b", "c")):
        _write_img(src / f"{name}.png", 64, 64, i + 1)
    _write_img(src / "d.png", 128, 64, 4)
    common = ["--weight_path", weights, "--preset", "tiny", "--batch", "2"]
    _run_port("compress", str(src), str(tmp_path / "ltc"), *common)
    assert sorted(os.listdir(tmp_path / "ltc")) == ["a.ltc", "b.ltc", "c.ltc", "d.ltc"]
    _run_port("decompress", str(tmp_path / "ltc"), str(tmp_path / "out"), *common)
    for name in "abcd":
        _run_port("compress", str(src / f"{name}.png"), str(tmp_path / f"{name}1.ltc"), *common)
        assert (tmp_path / f"{name}1.ltc").read_bytes() == (tmp_path / "ltc" / f"{name}.ltc").read_bytes()
        _run_port("decompress", str(tmp_path / f"{name}1.ltc"), str(tmp_path / f"{name}1.png"),
                  *common)
        np.testing.assert_array_equal(_png(tmp_path / "out" / f"{name}.png"),
                                      _png(tmp_path / f"{name}1.png"))
    assert _png(tmp_path / "out" / "d.png").shape == (128, 64, 3)


def test_c5_streams_decode_alike_in_any_batch(coder):
    """Fault C5: a stream's reconstruction does not depend on the batch it
    was encoded in or is decoded in."""
    rng = np.random.default_rng(7)
    items = [(f"{i}", rng.uniform(-1, 1, (50, 70, 3)).astype(np.float32)) for i in range(3)]
    alone = tcli.compress_images(coder, items, batch=1)
    together = tcli.compress_images(coder, items, batch=3)
    assert [b for _, b in alone] == [b for _, b in together]
    for blobs in (alone, together):
        recs_1 = tcli.decompress_streams(coder, blobs, batch=1)
        recs_3 = tcli.decompress_streams(coder, blobs, batch=3)
        for (n1, r1), (n3, r3) in zip(recs_1, recs_3):
            assert n1 == n3
            np.testing.assert_array_equal(r1, r3)


def test_truncated_file_and_wrong_preset_raise(tmp_path, weights, tiny_preset):
    src = tmp_path / "img.png"
    _write_img(src, 64, 64, 5)
    common = ["--weight_path", weights]
    _run_port("compress", str(src), str(tmp_path / "a.ltc"), *common, "--preset", "tiny")
    blob = (tmp_path / "a.ltc").read_bytes()
    (tmp_path / "cut.ltc").write_bytes(blob[:-40])
    with pytest.raises(ValueError):
        _run_port("decompress", str(tmp_path / "cut.ltc"), str(tmp_path / "r.png"), *common,
                  "--preset", "tiny")
    with pytest.raises(ValueError, match="produced by model 'tiny'"):
        _run_port("decompress", str(tmp_path / "a.ltc"), str(tmp_path / "r.png"), *common,
                  "--preset", "net_ga")


def _avg(out: str):
    line = next(l for l in out.splitlines() if l.startswith("AVG:"))
    return {k: float(v) for k, v in re.findall(r"(bpp|psnr|msssim)=([-\d.]+)", line)}


def test_eval_cli_avg_matches_jax(tmp_path, weights, tiny_preset, capsys):
    from lic_tpu.cli import eval as jeval_cli
    from lic_tpu_torch.cli import eval as teval_cli

    for i, (h, w) in enumerate(((50, 70), (64, 64))):
        _write_img(tmp_path / f"im{i}.png", h, w, 10 + i)
    argv = ["--data_path", str(tmp_path), "--weight_path", weights, "--preset", "tiny"]
    jeval_cli.main(argv)
    avg_j = _avg(capsys.readouterr().out)
    teval_cli.main([*argv, "--device", "cpu", "--write_bitstreams", str(tmp_path / "ltc")])
    out = capsys.readouterr().out
    avg_t = _avg(out)
    assert set(avg_t) == set(avg_j) == {"bpp", "psnr", "msssim"}
    for k in avg_j:
        np.testing.assert_allclose(avg_t[k], avg_j[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(tmp_path / "ltc")) == ["im0.ltc", "im1.ltc"]
