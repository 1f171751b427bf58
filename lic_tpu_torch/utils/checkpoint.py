"""Checkpoints: the JAX package's params-only ``.npz`` and the trainer's
torch state.

* ``save_params`` / ``load_params`` read and write the flat ``.npz`` of
  ``lic_tpu/utils/checkpoint.py:61-110``: one array per flax leaf, keyed by
  its path (``"g_a/c0/kernel"``), in the flax layout, so that a file
  written by either package loads into the other.  ``load_params`` is
  strict by default (every leaf present with its shape, as the
  reference's strict ``load_state_dict``).  A charm model has no
  ``PredictionModelSyntax`` (no charm forward reads it); its subtree is
  kept from the file loaded, or, for a model that loaded none, written
  from a seeded init of the port's ``PredictionModelSyntax``, so that the
  files carry the JAX package's whole parameter surface.  A neural-syntax
  model owns the module, and its leaves are the model's own.
* ``CheckpointManager`` keeps the trainer's state per epoch with
  ``torch.save``: the model's state dict, both optimizers' state, the
  schedule's count, the step, the noise and rate generators' states (and
  the device type of the noise generator's), the ``PredictionModelSyntax``
  subtree a charm model carries (``flax_extra``) and an optional ``extra``
  dict that the trainer does not read (``tools/orbax_state.py`` keeps the
  JAX leaves that have no port counterpart there).  A generator state
  saved on another device type than the one it is restored into (a file
  written on the CPU, resumed on the card) cannot be set: the generator is
  seeded with that state's seed instead.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .params import SKIPPED_PREFIX, flax_from_state, flax_leaves, to_torch_layout


def _syntax_subtree(model: nn.Module) -> Dict[str, np.ndarray]:
    """The ``prediction_model_syntax/*`` leaves: those ``load_params``
    kept, else a seeded init where the config builds the module; none
    for a model that owns the module (they are among its parameters)."""
    if hasattr(model, "prediction_model_syntax"):
        return {}
    kept = getattr(model, "flax_extra", None)
    if kept:
        return dict(kept)
    cfg = getattr(model, "cfg", None)
    if cfg is None or cfg.syntax == "none" or not cfg.code_syntax:
        return {}
    from ..models.syntax import PredictionModelSyntax

    pms = PredictionModelSyntax(cfg.N, cfg.M, 2 * cfg.M, "wam" if cfg.syntax == "wam" else "basic",
                                generator=torch.Generator().manual_seed(0))
    return flax_from_state(pms, SKIPPED_PREFIX)


def save_params(path: str, model: nn.Module) -> None:
    """The model's parameters as a flat flax-keyed ``.npz``."""
    arrays = flax_from_state(model)
    arrays.update(_syntax_subtree(model))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_params(path: str, model: nn.Module, strict: bool = True) -> nn.Module:
    """Load a ``save_params`` file (of either package) into ``model`` in
    place.  ``strict``: every leaf must be present with the right shape
    (KeyError / ValueError otherwise); without it a missing or
    mismatched leaf keeps the model's own value."""
    state = model.state_dict()
    expected = flax_from_state(model)
    skipped = []
    with np.load(path) as data:
        for skey, key, module, pname in flax_leaves(model):
            want = expected[key].shape
            if key not in data.files:
                if strict:
                    raise KeyError(f"checkpoint missing parameter {key}")
                skipped.append(key)
                continue
            arr = data[key]
            if arr.shape != want:
                if strict:
                    raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {want}")
                skipped.append(key)
                continue
            state[skey] = to_torch_layout(module, pname, arr)
        if not hasattr(model, "prediction_model_syntax"):
            model.flax_extra = {k: data[k] for k in data.files
                                if k.startswith(SKIPPED_PREFIX)}
    model.load_state_dict(state)
    if skipped:
        print(f"load_params: kept the model's own value for {len(skipped)} leaves "
              f"(e.g. {skipped[0]})")
    return model


def generator_seed(state: torch.Tensor, device_type: str) -> int:
    """The seed of a saved generator state: a CPU generator's as the CPU
    generator reads it back, a CUDA generator's from the first 8 bytes of
    its (seed, offset) state."""
    if device_type == "cpu":
        g = torch.Generator()
        g.set_state(state)
        return g.initial_seed()
    return int.from_bytes(bytes(state[:8].tolist()), "little")


class CheckpointManager:
    """Per-epoch trainer state under ``directory/<epoch:06d>.pt``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step:06d}.pt")

    def save(self, state, step: int, extra: Optional[dict] = None) -> None:
        model = getattr(state.model, "module", state.model)
        payload = {"model": model.state_dict(), "optimizer": state.optimizer.state_dict(),
                   "step": state.step, "generator": state.generator.get_state(),
                   "generator_device": state.generator.device.type,
                   "rate_generator": state.rate_generator.get_state()}
        kept = getattr(model, "flax_extra", None)
        if kept:
            payload["flax_extra"] = {k: torch.from_numpy(np.array(v)) for k, v in kept.items()}
        if extra is not None:
            payload["extra"] = extra
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))

    def load(self, step: int) -> dict:
        """The saved payload of ``step``, on the CPU."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = [int(f[:-3]) for f in os.listdir(self.directory)
                 if f.endswith(".pt") and f[:-3].isdigit()]
        return max(steps) if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint of ``step`` (default: the latest) into the
        ``TrainState`` given, in place; → the state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = self.load(step)
        model = getattr(state.model, "module", state.model)
        model.load_state_dict(payload["model"])
        if "flax_extra" in payload:
            model.flax_extra = {k: v.numpy() for k, v in payload["flax_extra"].items()}
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        saved_on = payload.get("generator_device", state.generator.device.type)
        if saved_on == state.generator.device.type:
            state.generator.set_state(payload["generator"])
        else:
            state.generator.manual_seed(generator_seed(payload["generator"], saved_on))
        if "rate_generator" in payload:  # files written before multi-rate training
            state.rate_generator.set_state(payload["rate_generator"])
        return state
