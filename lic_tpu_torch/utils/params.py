"""flax parameter tree → the port's state dict.

``params_from_flax(tree)`` takes the JAX package's parameter tree (nested
dicts of numpy arrays, as ``model.init(...)["params"]`` or a checkpoint
gives it) and returns a state dict for the port's ``CodecModel``.  It
applies the inverse of the layout rules of ``tools/import_torch.py``:

* conv kernels HWIO → OIHW;
* transposed-conv kernels: ``W_t[in, out, a, b] = kernel[k-1-a, k-1-b,
  in, out]`` (``lic_tpu/layers/conv.py:514-517``);
* ``nn.Dense`` kernels transposed to torch's ``(out, in)`` (the window
  attention's ``qkv`` and ``proj`` too);
* every other leaf (GDN β/Γ, entropy-bottleneck tensors, biases, the
  ``relative_position_bias_table``, which keeps the reference's
  ((2ws-1)², nh) layout) as is.

Module names follow the flax tree, except ``ResidualBlock``'s convs: flax
names them ``Conv2d_0`` / ``Conv2d_1``, the port ``conv1`` / ``conv2``.

Which rule a leaf takes is read off the port's own module types, on a
skeleton built on the meta device.  Every state-dict key must be filled
and every flax leaf used, except the subtree of the
``PredictionModelSyntax`` that no charm forward calls (prefix
``SKIPPED_PREFIX``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..config import CodecConfig
from ..layers import Conv2d, ConvTranspose2d, Linear, ResidualBlock
from ..models.codec import CodecModel
from ..models.presets import PRESETS

SKIPPED_PREFIX = "prediction_model_syntax/"
_RESBLOCK_NAMES = {"conv1": "Conv2d_0", "conv2": "Conv2d_1"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _flax_path(module_name: str) -> str:
    """``cc_mean_transforms.0.c1`` → ``cc_mean_transforms_0/c1`` (flax
    names list submodules ``name_i``)."""
    parts = []
    for p in module_name.split("."):
        if p.isdigit():
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return "/".join(parts)


def params_from_flax(
    tree: Mapping, cfg: Optional[CodecConfig] = None
) -> Dict[str, torch.Tensor]:
    """flax params of a ``source_net``-family model → the port's state dict.
    ``cfg`` (default ``source_net``) only selects the module types (widths
    do not matter)."""
    with torch.device("meta"):
        skeleton = CodecModel(cfg or PRESETS["source_net"])
    return state_from_flax(tree, skeleton)


def state_from_flax(tree: Mapping, skeleton: nn.Module) -> Dict[str, torch.Tensor]:
    """flax params → the state dict of ``skeleton``, a port module whose
    submodules mirror the tree (any device, ``meta`` included)."""
    flat = _flatten(tree)
    modules = dict(skeleton.named_modules())
    used, state = set(), {}
    for mname, module in modules.items():
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        parent, _, leaf = mname.rpartition(".")
        path = _flax_path(mname)
        if isinstance(modules.get(parent), ResidualBlock):
            path = f"{_flax_path(parent)}/{_RESBLOCK_NAMES[leaf]}"
        base = path + "/" if mname else ""
        for pname in own:
            if isinstance(module, (Conv2d, ConvTranspose2d, Linear)):
                key = base + ("kernel" if pname == "weight" else pname)
            else:
                key = base + pname
            if key not in flat:
                raise KeyError(f"flax tree has no leaf {key!r} for {mname}.{pname}")
            a = flat[key]
            used.add(key)
            if pname == "weight" and isinstance(module, Conv2d):
                a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
            elif pname == "weight" and isinstance(module, ConvTranspose2d):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)  # → (in, out, k, k)
            elif pname == "weight" and isinstance(module, Linear):
                a = a.T
            state[f"{mname}.{pname}" if mname else pname] = torch.from_numpy(
                np.ascontiguousarray(a, np.float32)
            )
    unused = sorted(
        k for k in flat if k not in used and not k.startswith(SKIPPED_PREFIX)
    )
    if unused:
        raise KeyError(f"flax leaves with no counterpart in the port: {unused}")
    return state
