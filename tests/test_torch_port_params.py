"""The flax → torch parameter bridge (``lic_tpu_torch.utils.params``) and
the port's copy of the preset table.

Every key of the port's state dict is filled from the JAX package's
``source_net`` and ``source_net_wam`` trees, every flax leaf is used except
the ``PredictionModelSyntax`` subtree (skipped by an explicit prefix), and
the layout rules (HWIO → OIHW, the transposed-conv flip, Dense transposes)
put each value where the port reads it.  The port's ``source_net_wam``
row equals the JAX package's field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import PRESETS as JPRESETS
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.models import build_model
from lic_tpu_torch.models.presets import PRESETS
from lic_tpu_torch.utils.params import SKIPPED_PREFIX, _flatten, params_from_flax
from jax_params import init_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return init_params(JCodecModel(jget_config("source_net", n_override=32)))


def test_every_key_filled_and_every_leaf_used(tree):
    sd = params_from_flax(tree)
    model = build_model("source_net", device="cpu", n_override=32)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # leaf counts agree: nothing in the tree was dropped
    assert len(sd) == len(_flatten(tree))
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_skipped_prefix_is_the_prediction_model_syntax(tree):
    """The JAX ``source_net`` builds a PredictionModelSyntax that no charm
    forward calls; a tree carrying its leaves (a checkpoint of the full
    parameter surface) converts, and the leaves are dropped."""
    assert SKIPPED_PREFIX == "prediction_model_syntax/"
    extra = dict(tree)
    extra["prediction_model_syntax"] = {
        "fc": {"kernel": np.zeros((4, 4), np.float32)}
    }
    sd = params_from_flax(extra)
    assert not any(k.startswith("prediction_model_syntax") for k in sd)
    assert set(sd) == set(params_from_flax(tree))
    bad = dict(tree)
    bad["mystery"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        params_from_flax(bad)


def test_layout_rules(tree):
    sd = params_from_flax(tree)
    k = tree["g_a"]["down1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["g_a.down1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = tree["h_mean_s"]["d0"]["kernel"]  # transposed conv, (k, k, in, out)
    w_t = sd["h_mean_s.d0.weight"].numpy()  # (in, out, k, k)
    assert w_t[3, 5, 0, 1] == d[4, 3, 3, 5]  # W_t[i, o, a, b] = K[k-1-a, k-1-b, i, o]
    np.testing.assert_array_equal(
        sd["g_s.up3.deconv.weight"].numpy(),
        tree["g_s"]["up3"]["deconv"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["conv_weights_gen.fc2.weight"].numpy(),
        tree["conv_weights_gen"]["fc2"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["cc_scale_transforms.2.c1.bias"].numpy(),
        tree["cc_scale_transforms_2"]["c1"]["bias"],
    )
    np.testing.assert_array_equal(
        sd["entropy_bottleneck.quantiles"].numpy(),
        tree["entropy_bottleneck"]["quantiles"],
    )
    np.testing.assert_array_equal(sd["g_s.igdn3.gamma"].numpy(), tree["g_s"]["igdn3"]["gamma"])


def test_source_net_wam_row_equals_jax_preset():
    """Field by field, as ``test_torch_port_ops.py`` holds ``source_net``."""
    name = "source_net_wam"
    assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(JPRESETS[name])


def test_every_key_filled_and_every_leaf_used_wam():
    """``source_net_wam``: the WAM subtrees map too — Dense kernels
    transposed, the rel-pos table as it is, ``ResidualBlock``'s
    ``Conv2d_0``/``Conv2d_1`` to ``conv1``/``conv2``."""
    jm = JCodecModel(jget_config("source_net_wam", n_override=32))
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 64, 64, 3)), training=True),
        jax.random.PRNGKey(0),
    )["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = params_from_flax(tree, PRESETS["source_net_wam"])
    model = build_model("source_net_wam", device="cpu", n_override=32)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(_flatten(tree))
    wba = tree["g_s"]["wam1"]["wba2"]["attn"]
    np.testing.assert_array_equal(sd["g_s.wam1.wba2.attn.qkv.weight"].numpy(), wba["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["g_s.wam1.wba2.attn.proj.weight"].numpy(), wba["proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["g_s.wam1.wba2.attn.relative_position_bias_table"].numpy(),
        wba["relative_position_bias_table"],
    )
    np.testing.assert_array_equal(
        sd["g_a.wam0.conv_a.1.conv2.weight"].numpy(),
        tree["g_a"]["wam0"]["conv_a_1"]["Conv2d_1"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["g_a.wam1.rb3.conv1.bias"].numpy(), tree["g_a"]["wam1"]["rb3"]["Conv2d_0"]["bias"]
    )



@pytest.mark.parametrize("name", ["net_ga", "net_unet_ha_hs_dec"])
def test_flagship_rows_and_every_leaf_used(name):
    """The flagship rows equal the JAX package's, and their trees map whole:
    ``LayerNorm`` scale → weight, the depthwise (3, 3, 1, C) kernel → (C, 1,
    3, 3), WMSA's (2ws-1, 2ws-1, nh) table as it is, ``SubpelConv2d`` and
    the Swin MLP's ``Dense`` kernels, the blocks' ``Conv2d_i`` names."""
    assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(JPRESETS[name])
    jm = JCodecModel(jget_config(name, n_override=32))
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 64, 64, 3)), training=True),
        jax.random.PRNGKey(0),
    )["params"]
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = params_from_flax(tree, PRESETS[name])
    model = build_model(name, device="cpu", n_override=32)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(_flatten(tree))
    blk = tree["atten_mean_2"]["non_local_block"]["block_2"]
    pre = "atten_mean.2.non_local_block.block_2."
    np.testing.assert_array_equal(sd[pre + "ln1.weight"].numpy(), blk["ln1"]["scale"])
    np.testing.assert_array_equal(sd[pre + "mlp_fc2.weight"].numpy(), blk["mlp_fc2"]["kernel"].T)
    np.testing.assert_array_equal(sd[pre + "msa.relative_position_params"].numpy(),
                                  blk["msa"]["relative_position_params"])
    np.testing.assert_array_equal(sd[pre + "msa.embedding_layer.weight"].numpy(),
                                  blk["msa"]["embedding_layer"]["kernel"].T)
    dw = tree["syntax_model"]["dw1"]["depthwise"]["kernel"]  # (3, 3, 1, 32)
    np.testing.assert_array_equal(sd["syntax_model.dw1.depthwise.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["atten_scale.0.gate.ru4.conv2.weight"].numpy(),
                                  tree["atten_scale_0"]["gate"]["ResidualUnit_4"]["Conv2d_1"]
                                  ["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["g_a.rbs1.gdn.gamma"].numpy(),
                                  tree["g_a"]["rbs1"]["GDN_0"]["gamma"])
    if name == "net_ga":
        np.testing.assert_array_equal(sd["h_mean_s.up1.weight"].numpy(),
                                      tree["h_mean_s"]["up1"]["kernel"].transpose(3, 2, 0, 1))
    else:
        up4 = tree["h_s"]["body"]["up4b"]["kernel"]  # a 1×1 transposed conv
        np.testing.assert_array_equal(sd["h_s.body.up4b.weight"].numpy(),
                                      up4.transpose(2, 3, 0, 1))
        np.testing.assert_array_equal(sd["h_a.conv2.conv.weight"].numpy(),
                                      tree["h_a"]["conv2"]["Conv2d_0"]["kernel"]
                                      .transpose(3, 2, 0, 1))
