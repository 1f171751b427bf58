"""flax parameter tree ↔ the port's state dict.

``params_from_flax(tree)`` takes the JAX package's parameter tree (nested
dicts of numpy arrays, as ``model.init(...)["params"]`` or a checkpoint
gives it) and returns a state dict for the port's ``CodecModel``;
``flax_from_state(module)`` goes the other way, to the flat
``"g_a/c0/kernel"`` keys of the JAX package's ``.npz`` checkpoints.  The
conversion applies the inverse of the layout rules of
``tools/import_torch.py``:

* conv kernels HWIO → OIHW (``SubpelConv2d``'s too; the depthwise
  (3, 3, 1, C) kernel so becomes torch's grouped (C, 1, 3, 3));
* transposed-conv kernels: ``W_t[in, out, a, b] = kernel[k-1-a, k-1-b,
  in, out]`` (``lic_tpu/layers/conv.py:514-517``);
* ``nn.Dense`` kernels transposed to torch's ``(out, in)`` (the window
  attention's ``qkv`` and ``proj``, WMSA's ``embedding_layer`` and
  ``linear``, the Swin MLP's ``mlp_fc1``/``mlp_fc2``);
* ``nn.LayerNorm``'s and ``nn.GroupNorm``'s ``scale`` to torch's
  ``weight`` (the ``bias`` as is);
* ``nn.Embed``'s ``embedding`` (the entroformer's
  ``relative_attention_bias``) to the parameter of that name;
* the HAN's ``CSAMModule`` kernel: flax's (3, 3, 3, 1, 1) to the port's
  (3, 3, 3) taps;
* every other leaf (GDN β/Γ, entropy-bottleneck tensors, biases, the
  gain units' (K, N) ``log_gain`` / ``log_inv_gain``, the
  ``relative_position_bias_table``, which keeps the reference's
  ((2ws-1)², nh) layout, and WMSA's (2ws-1, 2ws-1, nh)
  ``relative_position_params``) as is.

Module names follow the flax tree; where a port module names a child
otherwise (``ResidualBlock``'s ``conv1`` for flax's ``Conv2d_0``), its
class maps the names in ``FLAX_NAMES``.

Which rule a leaf takes is read off the port's own module types, on a
skeleton built on the meta device.  Every state-dict key must be filled
and every flax leaf used, except the subtree of the
``PredictionModelSyntax`` that no charm forward calls (prefix
``SKIPPED_PREFIX``); a neural-syntax model owns that module, and its
leaves are used like any other.  ``z2_sigma`` keeps the flax (1, 1, 1, N)
layout.  A module that a model calls twice (the latent U-Net's shared
stage-2 ``SpatialTransformer`` and conv) is one flax subtree and one set
of port parameters: ``named_modules`` lists it once.  The 1×1 convs of
``SpatialTransformer`` (flax ``nn.Conv``, HWIO with a bias) are the port's
``Conv2d`` and its bias-free Dense kernels its ``Linear(bias=False)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..config import CodecConfig
from ..layers import Conv2d, ConvTranspose2d, Linear, SubpelConv2d
from ..models.codec import CodecModel
from ..models.han import CSAMModule
from ..models.presets import PRESETS

SKIPPED_PREFIX = "prediction_model_syntax/"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _flax_path(module_name: str, modules: Optional[Mapping[str, nn.Module]] = None) -> str:
    """``cc_mean_transforms.0.c1`` → ``cc_mean_transforms_0/c1`` (flax
    names list submodules ``name_i``); a child that its parent's class
    lists in ``FLAX_NAMES`` takes the name given there."""
    parts, prefix = [], []
    for p in module_name.split(".") if module_name else []:
        parent = (modules or {}).get(".".join(prefix))
        prefix.append(p)
        if p.isdigit():
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(getattr(parent, "FLAX_NAMES", {}).get(p, p))
    return "/".join(parts)


def params_from_flax(
    tree: Mapping, cfg: Optional[CodecConfig] = None
) -> Dict[str, torch.Tensor]:
    """flax params of a charm model → the port's state dict.  ``cfg``
    (default ``source_net``) selects the module types; the widths are read
    off the tree."""
    with torch.device("meta"):
        skeleton = CodecModel(cfg or PRESETS["source_net"])
    return state_from_flax(tree, skeleton)


def flax_leaves(skeleton: nn.Module):
    """(state key, flax key, module, parameter name) of every parameter of
    ``skeleton``, in ``named_modules`` order."""
    modules = dict(skeleton.named_modules())
    for mname, module in modules.items():
        path = _flax_path(mname, modules)
        base = path + "/" if mname else ""
        for pname, _ in module.named_parameters(recurse=False):
            if isinstance(module, (Conv2d, ConvTranspose2d, Linear, SubpelConv2d)):
                key = base + ("kernel" if pname == "weight" else pname)
            elif pname == "relative_attention_bias":
                key = base + pname + "/embedding"
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                key = base + ("scale" if pname == "weight" else pname)
            else:
                key = base + pname
            yield (f"{mname}.{pname}" if mname else pname), key, module, pname


def to_torch_layout(module: nn.Module, pname: str, a: np.ndarray) -> torch.Tensor:
    """A flax leaf of ``module.<pname>`` in the port's layout."""
    if pname == "weight" and isinstance(module, (Conv2d, SubpelConv2d)):
        a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
    elif pname == "weight" and isinstance(module, ConvTranspose2d):
        a = a[::-1, ::-1].transpose(2, 3, 0, 1)  # → (in, out, k, k)
    elif pname == "weight" and isinstance(module, Linear):
        a = a.T
    elif pname == "conv" and isinstance(module, CSAMModule):
        a = a[..., 0, 0]
    # a fresh C-ordered copy: a flipped 1×1 kernel counts as contiguous to
    # numpy but keeps its negative strides
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def to_flax_layout(module: nn.Module, pname: str, t: torch.Tensor) -> np.ndarray:
    """``module.<pname>`` in the flax layout (the inverse of
    ``to_torch_layout``), as a C-ordered float32 array."""
    a = t.detach().float().cpu().numpy()
    if pname == "weight" and isinstance(module, (Conv2d, SubpelConv2d)):
        a = a.transpose(2, 3, 1, 0)  # OIHW → HWIO
    elif pname == "weight" and isinstance(module, ConvTranspose2d):
        a = a.transpose(2, 3, 0, 1)[::-1, ::-1]  # (in, out, k, k) → flipped HWIO
    elif pname == "weight" and isinstance(module, Linear):
        a = a.T
    elif pname == "conv" and isinstance(module, CSAMModule):
        a = a[..., None, None]
    return np.array(a, np.float32, order="C")


def state_from_flax(tree: Mapping, skeleton: nn.Module) -> Dict[str, torch.Tensor]:
    """flax params → the state dict of ``skeleton``, a port module whose
    submodules mirror the tree (any device, ``meta`` included)."""
    flat = _flatten(tree)
    used, state = set(), {}
    for skey, key, module, pname in flax_leaves(skeleton):
        if key not in flat:
            raise KeyError(f"flax tree has no leaf {key!r} for {skey}")
        used.add(key)
        state[skey] = to_torch_layout(module, pname, flat[key])
    unused = sorted(
        k for k in flat if k not in used and not k.startswith(SKIPPED_PREFIX)
    )
    if unused:
        raise KeyError(f"flax leaves with no counterpart in the port: {unused}")
    return state


def flax_from_state(module: nn.Module, prefix: str = "") -> Dict[str, np.ndarray]:
    """The parameters of ``module`` as flat flax keys (``prefix`` before
    each) → arrays in the flax layout."""
    params = dict(module.named_parameters())
    return {prefix + key: to_flax_layout(mod, pname, params[skey])
            for skey, key, mod, pname in flax_leaves(module)}
