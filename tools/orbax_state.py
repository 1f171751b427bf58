"""Carry a training state between the JAX package's Orbax ``TrainState``
and the PyTorch port's ``CheckpointManager`` file, both ways.

Runs on a CPU host that has both packages and JAX, optax and Orbax (it
imports all four); a host with no JAX, as a GPU host may be, cannot run
it.  The usual crossing: train on the TPU, convert here, resume with the
port's trainer on the GPU::

    python tools/orbax_state.py to_torch CKPT_DIR STEP PRESET OUT_DIR
    python tools/orbax_state.py to_orbax PT_DIR STEP PRESET OUT_DIR

``orbax_to_torch`` reads ``CKPT_DIR/<step:06d>`` (``lic_tpu/utils/checkpoint.py``)
and writes ``OUT_DIR/<step:06d>.pt``, which the port's
``CheckpointManager(OUT_DIR).restore(state, step)`` loads into a
``TrainState`` whose optimizer ``make_optimizer`` built (after
``freeze_partition`` for a model with the HAN tail, as ``train`` does).
``torch_to_orbax`` goes the other way, into a ``TrainState`` that the JAX
``CheckpointManager.restore`` loads.  What crosses:

* the parameters, through ``lic_tpu_torch.utils.params``; the
  ``PredictionModelSyntax`` subtree that a charm model of the port does not
  own rides in the file's ``flax_extra``;
* Adam's μ and ν of every leaf, in that leaf's layout, for the main and
  the aux (``quantiles``) transforms of ``lic_tpu/training/train.py:99-128``,
  in the ``freeze_partition`` layout too (a frozen leaf has none on
  either side); those of leaves without a port counterpart ride in the
  file's ``extra``;
* optax's counts: the main Adam's and the aux Adam's into the port's
  per-group ``count``, the schedule's into ``CodecOptimizer.count``.
  optax advances them together, one per applied update, so a count the
  port does not keep (the aux Adam of a phase with no aux leaves) is
  rebuilt from the schedule's;
* the step.

The JAX ``rng`` is a threefry key, which no torch generator reproduces.
``orbax_to_torch`` seeds the port's noise generator with the key's two
32-bit words as one 64-bit integer (k0·2³² + k1) and its rate generator
with that integer + 1 (mod 2⁶⁴), and keeps the key in the file's
``extra``: ``torch_to_orbax`` restores it exactly.  A file that holds no
key (a state the port began) gets the key made of its noise generator's
seed by the inverse rule.  Noise and rate draws after a resume therefore
differ from those of the run the other package would have made; the
parameters, the optimizer state and the step do not.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _flat(tree, prefix="") -> Dict[str, np.ndarray]:
    """A nested dict → {"a/b/c": array}, skipping None (a masked leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    out = {}
    for key, a in flat.items():
        d = out
        *parents, leaf = key.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = a
    return out


def _adam_states(node, path=()):
    """(path, state) of every Adam state ({count, mu, nu}) and schedule state
    ({count}) in an Orbax-restored optax state (namedtuples as dicts,
    tuples as lists, masked and empty states as None)."""
    if isinstance(node, dict):
        if set(node) == {"count", "mu", "nu"} or set(node) == {"count"}:
            yield path, node
            return
        for k, v in node.items():
            yield from _adam_states(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _adam_states(v, path + (str(i),))


def _seeds(key: np.ndarray):
    seed = (int(key[0]) << 32) | int(key[1])
    return seed, (seed + 1) % 2 ** 64


def _port_state(preset: str, post_processing_phase: bool, train_cfg, overrides):
    """The port's model (CPU), optimizer and ``TrainState`` as its trainer
    builds them."""
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.training import create_state, freeze_partition, make_optimizer

    model = build_model(preset, device="cpu", **overrides)
    if model.cfg.post_processing:
        freeze_partition(model, post_processing_phase)
    opt = make_optimizer(model, train_cfg, 1, post_processing_phase)
    return model, opt, create_state(model, opt, train_cfg.seed)


def orbax_to_torch(ckpt_dir: str, step: int, preset: str, out_dir: str,
                   post_processing_phase: bool = False, train_cfg=None, **overrides) -> str:
    """The JAX ``TrainState`` of ``ckpt_dir/<step:06d>`` → the port's
    ``out_dir/<step:06d>.pt``; → its path.  ``overrides`` go to the
    preset's config (as ``build_model``'s); ``train_cfg`` is the port's
    ``TrainConfig`` the JAX run trained with (its default)."""
    import orbax.checkpoint as ocp
    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.training.train import aux_labels
    from lic_tpu_torch.utils.checkpoint import CheckpointManager
    from lic_tpu_torch.utils.params import SKIPPED_PREFIX, flax_leaves, state_from_flax
    from lic_tpu_torch.utils.params import to_torch_layout

    train_cfg = train_cfg or TrainConfig()
    raw = ocp.StandardCheckpointer().restore(os.path.join(os.path.abspath(ckpt_dir),
                                                          f"{step:06d}"))
    model, opt, state = _port_state(preset, post_processing_phase, train_cfg, overrides)
    params = _flat(raw["params"])
    model.load_state_dict(state_from_flax(_nest(params), model))
    model.flax_extra = {k: v for k, v in params.items() if k.startswith(SKIPPED_PREFIX)}

    labels, named = aux_labels(model), dict(model.named_parameters())
    leaves = {key: (skey, mod, pname) for skey, key, mod, pname in flax_leaves(model)}
    counts, rest = {}, {"mu": {}, "nu": {}}
    for path, st in _adam_states(raw["opt_state"]):
        group = "aux" if "aux" in path else "main"
        if "mu" not in st:
            counts["schedule"] = int(st["count"])
            continue
        counts[group] = int(st["count"])
        adam = opt.aux if group == "aux" else opt.main
        mu, nu = _flat(st["mu"]), _flat(st["nu"])
        for key in mu:
            if key not in leaves:
                rest["mu"][key] = torch.from_numpy(mu[key].copy())
                rest["nu"][key] = torch.from_numpy(nu[key].copy())
                continue
            skey, mod, pname = leaves[key]
            p = named[skey]
            if not p.requires_grad or labels[skey] != group:
                raise ValueError(f"{key}: Adam state in the '{group}' transform, but the "
                                 "port's optimizer does not hold this leaf there")
            adam.state[p] = {"mu": to_torch_layout(mod, pname, mu[key]),
                             "nu": to_torch_layout(mod, pname, nu[key])}
    for group, adam in (("main", opt.main), ("aux", opt.aux)):
        if adam is not None:
            adam.param_groups[0]["count"] = counts[group]
    opt.count = counts["schedule"]
    state.step = int(raw["step"])
    key = np.asarray(raw["rng"]).astype(np.uint32)
    seed, rate_seed = _seeds(key)
    state.generator.manual_seed(seed)
    state.rate_generator.manual_seed(rate_seed)
    extra = {"jax_rng": torch.from_numpy(key.astype(np.int64)), **rest}
    CheckpointManager(out_dir).save(state, step, extra=extra)
    return os.path.join(os.path.abspath(out_dir), f"{step:06d}.pt")


def torch_to_orbax(pt_dir: str, step: int, preset: str, out_dir: str,
                   post_processing_phase: bool = False, train_cfg=None, **overrides) -> str:
    """The port's ``pt_dir/<step:06d>.pt`` → a JAX ``TrainState`` at
    ``out_dir/<step:06d>``; → its path.  Arguments as ``orbax_to_torch``."""
    import jax
    import jax.numpy as jnp
    import optax

    from lic_tpu.config import TrainConfig as JTrainConfig
    from lic_tpu.training.train import TrainState, freeze_partition
    from lic_tpu.training.train import make_optimizer as jmake_optimizer
    from lic_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.utils.checkpoint import CheckpointManager, _syntax_subtree
    from lic_tpu_torch.utils.params import flax_from_state, flax_leaves, to_flax_layout

    train_cfg = train_cfg or TrainConfig()
    model, opt, state = _port_state(preset, post_processing_phase, train_cfg, overrides)
    manager = CheckpointManager(pt_dir)
    payload = manager.load(step)
    manager.restore(state, step)
    extra = payload.get("extra", {})
    params = flax_from_state(model)
    params.update(_syntax_subtree(model))

    moments = {"mu": dict(extra.get("mu", {})), "nu": dict(extra.get("nu", {}))}
    moments = {m: {k: v.numpy() for k, v in d.items()} for m, d in moments.items()}
    groups = {}
    for group, adam in (("main", opt.main), ("aux", opt.aux)):
        if adam is None:
            continue
        groups[group] = adam.param_groups[0]["count"]
        held = {id(p) for p in adam.param_groups[0]["params"]}
        named = dict(model.named_parameters())
        for skey, key, mod, pname in flax_leaves(model):
            p = named[skey]
            if id(p) not in held:
                continue
            st = adam.state.get(p)
            for m in ("mu", "nu"):
                moments[m][key] = (to_flax_layout(mod, pname, st[m]) if st
                                   else np.zeros(params[key].shape, np.float32))

    jcfg = JTrainConfig(**{f: getattr(train_cfg, f) for f in JTrainConfig.__dataclass_fields__})
    jopt = jmake_optimizer(jcfg, 1, post_processing_phase)
    tree = jax.tree.map(jnp.asarray, _nest(params))
    if model.cfg.post_processing:
        jopt = freeze_partition(jopt, tree, post_processing_phase)
    template = jax.eval_shape(jopt.init, tree)  # every leaf is replaced below

    def fill(path, node):
        names = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                 for k in path]
        group = "aux" if "aux" in names else "main"
        if isinstance(node, optax.ScaleByScheduleState):
            return node._replace(count=jnp.asarray(opt.count, jnp.int32))
        if not isinstance(node, optax.ScaleByAdamState):
            raise ValueError(f"optax state {type(node).__name__} at {names} has no counterpart")
        count = jnp.asarray(groups.get(group, opt.count), jnp.int32)

        def moment(m):
            def leaf(lpath, a):
                key = "/".join(str(getattr(k, "key", k)) for k in lpath)
                return jnp.asarray(moments[m].get(key, np.zeros(a.shape)), a.dtype)
            return jax.tree_util.tree_map_with_path(leaf, getattr(node, m))

        return node._replace(count=count, mu=moment("mu"), nu=moment("nu"))

    is_state = lambda n: isinstance(n, (optax.ScaleByAdamState, optax.ScaleByScheduleState,
                                        jax.ShapeDtypeStruct))
    opt_state = jax.tree_util.tree_map_with_path(fill, template, is_leaf=is_state)
    if "jax_rng" in extra:
        key = extra["jax_rng"].numpy().astype(np.uint32)
    else:
        seed = state.generator.initial_seed()
        key = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    jstate = TrainState(step=jnp.asarray(state.step, jnp.int32), params=tree,
                        opt_state=opt_state, rng=jnp.asarray(key))
    jman = JCheckpointManager(out_dir)
    jman.save(jstate, step)
    jman.wait()
    return os.path.join(os.path.abspath(out_dir), f"{step:06d}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="Convert a training state between the JAX "
                                             "package's Orbax TrainState and the port's "
                                             "CheckpointManager file.")
    ap.add_argument("direction", choices=("to_torch", "to_orbax"))
    ap.add_argument("src_dir")
    ap.add_argument("step", type=int)
    ap.add_argument("preset")
    ap.add_argument("out_dir")
    ap.add_argument("--post_processing_phase", action="store_true")
    args = ap.parse_args(argv)
    fn = orbax_to_torch if args.direction == "to_torch" else torch_to_orbax
    print(fn(args.src_dir, args.step, args.preset, args.out_dir, args.post_processing_phase))
    return 0


if __name__ == "__main__":
    sys.exit(main())
