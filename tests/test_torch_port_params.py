"""The flax → torch parameter bridge (``lic_tpu_torch.utils.params``).

Every key of the port's state dict is filled from the JAX package's
``source_net`` tree, every flax leaf is used except the
``PredictionModelSyntax`` subtree (skipped by an explicit prefix), and the
layout rules (HWIO → OIHW, the transposed-conv flip, Dense transposes) put
each value where the port reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.models.codec import CodecModel as JCodecModel
from lic_tpu.models.presets import get_config as jget_config
from lic_tpu_torch.models import build_model
from lic_tpu_torch.utils.params import SKIPPED_PREFIX, _flatten, params_from_flax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    jm = JCodecModel(jget_config("source_net", n_override=32))
    init = jax.jit(
        lambda k: jm.init(
            {"params": k, "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, 64, 64, 3)), training=True,
        )
    )
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0))["params"])


def test_every_key_filled_and_every_leaf_used(tree):
    sd = params_from_flax(tree)
    model = build_model("source_net", n_override=32)
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
