"""The training-state tool ``tools/orbax_state.py`` and the port's
``CheckpointManager``, against the JAX trainer's Orbax ``TrainState``.

States: ``source_net`` at ``n_override=32`` (phase 1: main and aux Adam)
and with ``post_processing=True`` in its HAN phase (phase 2: the
``freeze_partition`` layout, AdamW on the tail alone).  Parameters are the
port's seeded init carried by ``utils.params``; the JAX state takes two
optax updates of the JAX ``make_optimizer`` (``freeze_partition`` for the
HAN model) with gradients drawn from a numpy seed (0 on the
``PredictionModelSyntax`` leaves, which no charm forward reads).  Then:

* ``orbax_to_torch``, ``CheckpointManager.restore`` into the port's
  ``TrainState``, and a third update with the same gradients through the
  port's ``CodecOptimizer``: every parameter within 1e-6 of the largest
  update's magnitude of optax's third update, or within two ulps of the
  parameter where that is more (each side rounds p + u to p's ulp);
* ``orbax_to_torch`` → ``torch_to_orbax`` → the JAX ``CheckpointManager``
  restores a state bit-identical to the first, leaf for leaf (the key
  included);
* a state the port began crosses to Orbax and back bit-identical too,
  its key made of the noise generator's seed.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lic_tpu.config import TrainConfig as JTrainConfig
from lic_tpu.training.train import TrainState as JTrainState
from lic_tpu.training.train import freeze_partition as jfreeze_partition
from lic_tpu.training.train import make_optimizer as jmake_optimizer
from lic_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from lic_tpu_torch.config import TrainConfig
from lic_tpu_torch.models import build_model
from lic_tpu_torch.training import create_state, freeze_partition, make_optimizer
from lic_tpu_torch.utils.checkpoint import CheckpointManager, _syntax_subtree
from lic_tpu_torch.utils.params import flax_from_state, flax_leaves, to_torch_layout

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import orbax_state  # noqa: E402

OVER = dict(n_override=32)
CFG = dict(lr=1e-2, aux_lr=1e-3, lr_milestones=(1,), lr_gamma=0.5)
PHASES = {"phase1": dict(pp=False, over={}), "han_phase2": dict(pp=True, over=dict(
    post_processing=True))}


def _nest(flat):
    out = {}
    for key, a in flat.items():
        d = out
        *parents, leaf = key.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(a)
    return out


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(params, seed):
    """Gradients for every leaf: N(0, 0.01²), 0 on the syntax model the
    forward never reads."""
    rng = np.random.default_rng(seed)
    return {k: (np.zeros_like(a) if k.startswith("prediction_model_syntax/")
                else (0.01 * rng.standard_normal(a.shape)).astype(np.float32))
            for k, a in params.items()}


_RUNS = {}


def _jax_run(phase, tmp_path_factory):
    """The JAX state after two updates, saved at step 2, once per phase →
    (its directory, the state, the jitted step, the third gradients)."""
    if phase in _RUNS:
        return _RUNS[phase]
    spec = PHASES[phase]
    model = build_model("source_net", device="cpu", **OVER, **spec["over"])
    params = flax_from_state(model)
    params.update(_syntax_subtree(model))
    opt = jmake_optimizer(JTrainConfig(**CFG), 2, spec["pp"])
    tree = _nest(params)
    if spec["pp"]:
        opt = jfreeze_partition(opt, tree, True)
    state = opt.init(tree)

    @jax.jit
    def step(g, s, p):
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for i in range(2):
        tree, state = step(_nest(_grads(params, i)), state, tree)
    jstate = JTrainState(step=jnp.asarray(2, jnp.int32), params=tree, opt_state=state,
                         rng=jax.random.PRNGKey(11))
    path = tmp_path_factory.mktemp(f"jax_{phase}")
    manager = JCheckpointManager(str(path))
    manager.save(jstate, 2)
    manager.wait()
    _RUNS[phase] = path, jstate, step, _grads(params, 2)
    return _RUNS[phase]


def _restore_jax(path, like):
    return JCheckpointManager(path).restore(like, 2)


def _keyed(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("phase", list(PHASES))
def test_orbax_state_resumes_in_the_port_and_crosses_back_bit_identical(
        phase, tmp_path, tmp_path_factory):
    spec = PHASES[phase]
    jdir, jstate, step, g3 = _jax_run(phase, tmp_path_factory)
    kw = dict(**OVER, **spec["over"])
    orbax_state.orbax_to_torch(str(jdir), 2, "source_net", str(tmp_path / "pt"), spec["pp"],
                               TrainConfig(**CFG), **kw)

    # the port resumes: its third update is optax's
    tm = build_model("source_net", device="cpu", seed=5, **kw)
    if spec["pp"]:
        freeze_partition(tm, True)
    topt = make_optimizer(tm, TrainConfig(**CFG), 2, spec["pp"])
    state = CheckpointManager(str(tmp_path / "pt")).restore(create_state(tm, topt), 2)
    assert state.step == 2 and topt.count == 2
    want = _keyed(step(_nest(g3), jstate.opt_state, jstate.params)[0])
    before = flax_from_state(tm)
    named = dict(tm.named_parameters())
    for skey, key, mod, pname in flax_leaves(tm):
        if named[skey].requires_grad:
            named[skey].grad = to_torch_layout(mod, pname, g3[key])
    assert topt.step_if_finite()
    got = flax_from_state(tm)
    biggest = max(float(np.abs(want[k] - before[k]).max()) for k in got)
    for key, a in got.items():  # p + u rounds to p's ulp on both sides
        tol = np.maximum(1e-6 * biggest, 2 * np.spacing(np.abs(want[key])))
        assert (np.abs(a - want[key]) <= tol).all(), key
    moved = [k for k in got if np.any(got[k] != before[k])]
    assert len(moved) > 10
    if spec["pp"]:  # the tail alone moves
        assert all(k.split("/")[0] in ("han", "conv_weights_gen_han") for k in moved)

    # and the file crosses back to the state it came from, bit for bit
    orbax_state.torch_to_orbax(str(tmp_path / "pt"), 2, "source_net", str(tmp_path / "back"),
                               spec["pp"], TrainConfig(**CFG), **kw)
    first = _flat(jstate)  # what was saved
    back = _flat(_restore_jax(str(tmp_path / "back"), jstate))
    assert first.keys() == back.keys() and len(first) > 100
    for k in first:
        assert first[k].dtype == back[k].dtype and np.array_equal(first[k], back[k]), k


def test_port_state_crosses_to_orbax_and_back(tmp_path):
    """A state the port began (one training step): its key is made of the
    noise generator's seed, and the return trip gives the port's file
    back, parameters, moments, counts, step and generators equal."""
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.training import make_train_step

    tm = build_model("source_net", device="cpu", **OVER)
    cfg = TrainConfig(**CFG)
    topt = make_optimizer(tm, cfg, 2)
    state = create_state(tm, topt, seed=3)
    x = torch.from_numpy(smooth_images(np.random.default_rng(0), 1, 64, 64))
    make_train_step(tm.train(), cfg, topt)(state, x)
    CheckpointManager(str(tmp_path / "pt")).save(state, 1)
    orbax_state.torch_to_orbax(str(tmp_path / "pt"), 1, "source_net", str(tmp_path / "jax"),
                               False, cfg, **OVER)
    orbax_state.orbax_to_torch(str(tmp_path / "jax"), 1, "source_net", str(tmp_path / "pt2"),
                               False, cfg, **OVER)
    a = CheckpointManager(str(tmp_path / "pt")).load(1)
    b = CheckpointManager(str(tmp_path / "pt2")).load(1)
    assert b["extra"]["jax_rng"].tolist() == [0, 5]  # seed 3 + 2, as create_state seeds it
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for grp in ("main", "aux"):
        sa, sb = a["optimizer"][grp], b["optimizer"][grp]
        assert sa["param_groups"][0]["count"] == sb["param_groups"][0]["count"] == 1
        for i, st in sa["state"].items():
            assert all(torch.equal(st[m], sb["state"][i][m]) for m in ("mu", "nu")), (grp, i)
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 1 and a["step"] == b["step"]
