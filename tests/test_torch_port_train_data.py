"""Port parity of the training input and checkpoints, on the CPU.

* ``TrainConfig``'s defaults equal the JAX package's, field by field;
* ``train_iterator`` at ``num_threads=1`` yields the JAX iterator's crops
  for the same seed, bit for bit, on PNGs written to ``tmp_path`` (smaller
  and larger than the crop: the symmetric tiling runs);
* ``.npz`` checkpoints: a JAX ``save_params`` file loads into the port
  (strict) and a port file loads into the JAX package (strict), both
  exactly; a shape mismatch or a missing leaf raises; ``strict=False``
  keeps the model's own value;
* ``CheckpointManager`` restores the trainer's state, and a restored run
  takes the step the uninterrupted one takes, bit for bit;
* the CLI trains two steps of ``source_net`` on the CPU and writes
  ``final.npz``, which the port loads back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.config import TrainConfig as JTrainConfig
from lic_tpu.data import datasets as jdata
from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu.utils import checkpoint as jckpt

from lic_tpu_torch.config import TrainConfig
from lic_tpu_torch.data import ImageFolderDataset, synthetic_batches, train_iterator
from lic_tpu_torch.models import build_model
from lic_tpu_torch.training import create_state, make_optimizer, make_train_step
from lic_tpu_torch.utils.checkpoint import CheckpointManager, load_params, save_params
from lic_tpu_torch.utils.params import params_from_flax

torch.set_num_threads(2)


def test_train_config_defaults_equal_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


@pytest.fixture
def png_dir(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(20)
    for i, (h, w) in enumerate([(40, 52), (90, 70), (64, 64), (120, 100)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.png")
    return tmp_path


def test_train_iterator_matches_jax_crops(png_dir):
    jit = jdata.train_iterator(jdata.ImageFolderDataset(str(png_dir), crop_size=64), 3,
                               seed=5, num_threads=1)
    tit = train_iterator(ImageFolderDataset(str(png_dir), crop_size=64), 3, seed=5,
                         num_threads=1, device="cpu")
    try:
        for _ in range(4):
            ref = np.asarray(next(jit))
            got = next(tit)
            assert got.shape == (3, 3, 64, 64)
            assert got.is_contiguous(memory_format=torch.channels_last)
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    finally:
        jit.close()
        tit.close()


def test_synthetic_batches_are_the_jax_draws():
    ref = next(jdata.synthetic_batches(2, 16, seed=3))
    got = next(synthetic_batches(2, 16, seed=3, device="cpu"))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.fixture(scope="module")
def jax_params():
    jm = JCodecModel(jget_config("source_net", n_override=32))
    init = jax.jit(lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 64, 64, 3)), training=True))
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0))["params"])


def test_npz_round_trips_between_the_packages(jax_params, tmp_path):
    # JAX → port, strict
    jckpt.save_params(str(tmp_path / "jax.npz"), jax_params)
    tm = build_model("source_net", device="cpu", n_override=32, seed=9)
    load_params(str(tmp_path / "jax.npz"), tm)
    want = params_from_flax(jax_params)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k
    # port → JAX, strict, after a change on the port side
    with torch.no_grad():
        tm.g_a.down0.weight.mul_(2.0)
    save_params(str(tmp_path / "port.npz"), tm)
    back = jckpt.load_params(str(tmp_path / "port.npz"), jax_params, strict=True)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(jax_params)[0])
    for path, ref in flat_ref.items():
        got = np.asarray(flat_back[path])
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name == "g_a/down0/kernel":
            np.testing.assert_array_equal(got, 2.0 * ref)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)


def test_fresh_port_file_loads_into_jax_strict(jax_params, tmp_path):
    """A port model that never loaded a JAX file still writes every leaf the
    JAX model has (the PredictionModelSyntax subtree from a seeded init)."""
    tm = build_model("source_net", device="cpu", n_override=32)
    save_params(str(tmp_path / "fresh.npz"), tm)
    jckpt.load_params(str(tmp_path / "fresh.npz"), jax_params, strict=True)


def test_npz_shape_mismatch_and_missing_leaf(jax_params, tmp_path):
    jckpt.save_params(str(tmp_path / "n32.npz"), jax_params)
    small = build_model("source_net", device="cpu", n_override=16)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params(str(tmp_path / "n32.npz"), small)
    arrays = dict(np.load(tmp_path / "n32.npz"))
    del arrays["g_s/up0/deconv/kernel"]
    np.savez(tmp_path / "missing.npz", **arrays)
    tm = build_model("source_net", device="cpu", n_override=32, seed=9)
    own = tm.g_s.up0.deconv.weight.detach().clone()
    with pytest.raises(KeyError, match="g_s/up0/deconv/kernel"):
        load_params(str(tmp_path / "missing.npz"), tm)
    load_params(str(tmp_path / "missing.npz"), tm, strict=False)
    assert torch.equal(tm.g_s.up0.deconv.weight, own)
    assert torch.equal(tm.g_a.down0.weight, params_from_flax(jax_params)["g_a.down0.weight"])


def test_checkpoint_manager_restores_the_train_state(tmp_path):
    x = next(synthetic_batches(2, 64, seed=1, device="cpu"))
    tc = TrainConfig()

    def fresh():
        m = build_model("source_net", device="cpu", n_override=16).train()
        opt = make_optimizer(m, tc, steps_per_epoch=10)
        return create_state(m, opt, tc.seed), make_train_step(m, tc, opt)

    state, step = fresh()
    for _ in range(2):
        step(state, x)
    CheckpointManager(str(tmp_path)).save(state, 1)
    ref = step(state, x)
    state2, step2 = fresh()
    CheckpointManager(str(tmp_path)).restore(state2)
    assert state2.step == 2 and state2.optimizer.count == 2
    got = step2(state2, x)
    assert float(got["loss"]) == float(ref["loss"])
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)


def test_cli_trains_two_steps_on_the_cpu(png_dir, tmp_path):
    from lic_tpu_torch.cli.train import main

    out = tmp_path / "ckpt"
    main(["--train_data_path", str(png_dir), "--preset", "source_net", "--batch_size", "2",
          "--crop_size", "64", "--epochs", "1", "--steps_per_epoch", "2",
          "--checkpoint_dir", str(out), "--device", "cpu"])
    assert (out / "final.npz").exists()
    log = (out / "train_log.txt").read_text()
    assert log.startswith("[Epoch 0000 TRAIN] Loss: ")
    tm = build_model("source_net", device="cpu", seed=3)
    before = tm.g_a.down0.weight.detach().clone()
    load_params(str(out / "final.npz"), tm)
    assert not torch.equal(tm.g_a.down0.weight, before)
    assert all(torch.isfinite(p).all() for p in tm.parameters())
