"""Weight-init schemes over a module's parameters (counterpart of
``lic_tpu/utils/init.py``): the reference's ``model.apply(weight_init)``
walkers (``model/util.py:175-283``).

``apply_init_scheme(module, scheme, generator)`` visits every parameter by
its flax leaf (``utils.params.flax_leaves``): a ``kernel`` of rank >= 2 in
the flax layout (a conv's HWIO, a Dense's (in, out)) is redrawn, each
``bias`` zeroed, each rank-1 ``scale`` (a LayerNorm's or GroupNorm's
weight) set to ones; every other leaf (GDN β/Γ, the entropy models'
tables, position tables) keeps its value.  The draw is made in the flax
layout and carried to the port's by ``to_torch_layout``, so the fans are
JAX's ``_fans`` of HWIO: a ``ConvTranspose2d`` weight, (in, out, k, k) in
torch, draws with fan_in = k·k·in, where torch's own rule would swap the
two.  Each leaf draws from its own stream, seeded from one draw of
``generator`` and the SHA-256 of its flax path, so the result does not
depend on the order of the visit.  The values are not JAX's draws (the
generators differ); their distributions are.

``trunc_normal_array`` is the reference's ``_no_grad_trunc_normal_``:
uniform → erfinv on [a, b] in pre-scale units, then × std + mean, then
clamped to [a, b].
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

SCHEMES = ("xavier_uniform", "xavier_normal", "kaiming_normal", "lecun", "vit2")


def trunc_normal_array(shape: Tuple[int, ...], mean: float = 0.0, std: float = 1.0,
                       a: float = -2.0, b: float = 2.0,
                       generator: Optional[torch.Generator] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """A bounded truncated normal, as ``lic_tpu/utils/init.py:47-67``."""
    lo = (1.0 + math.erf(a / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(b / math.sqrt(2.0))) / 2.0
    u = torch.empty(shape, dtype=torch.float32).uniform_(2 * lo - 1, 2 * hi - 1,
                                                         generator=generator)
    x = torch.erfinv(u) * math.sqrt(2.0) * std + mean
    return torch.clamp(x, a, b).to(dtype)


def trunc_normal(std: float = 0.02) -> Callable:
    """timm's truncated normal as an initializer: ``init(shape, generator)``."""
    def init(shape, generator=None, dtype=torch.float32):
        return trunc_normal_array(tuple(shape), std=std, generator=generator, dtype=dtype)

    return init


def vit2_init(std: float = 0.02) -> Callable:
    """The linear branch of the reference's ``vit2_init``."""
    return trunc_normal(std)


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """fan_in, fan_out of a Dense (I, O) or conv HWIO (kh, kw, I, O) kernel."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _draw(scheme: str, shape, generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)

    def uniform(limit):
        return torch.empty(shape).uniform_(-limit, limit, generator=generator)

    def normal(std):
        return torch.randn(shape, generator=generator) * std

    if scheme == "xavier_uniform" or (scheme == "vit2" and len(shape) != 2):
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if scheme == "xavier_normal":
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme == "kaiming_normal":  # fan_in mode, gain √2
        return normal(math.sqrt(2.0 / fan_in))
    if scheme == "lecun":
        return trunc_normal_array(shape, std=math.sqrt(1.0 / fan_in), generator=generator)
    return trunc_normal_array(shape, std=0.02, generator=generator)  # vit2's linears


def apply_init_scheme(module: nn.Module, scheme: str = "xavier_uniform",
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise ``module``'s parameters in place per ``scheme`` (see the
    module docstring); → the module."""
    from .params import flax_leaves, to_flax_layout, to_torch_layout

    if scheme not in SCHEMES:
        raise ValueError(f"unknown init scheme {scheme!r}; pick from {SCHEMES}")
    base = int(torch.randint(0, 2 ** 62, (), generator=generator))
    params = dict(module.named_parameters())
    with torch.no_grad():
        for skey, key, mod, pname in list(flax_leaves(module)):
            p, leaf = params[skey], key.rsplit("/", 1)[-1]
            if leaf == "kernel" and p.dim() >= 2:
                flax_shape = to_flax_layout(mod, pname, torch.zeros(p.shape)).shape
                digest = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
                g = torch.Generator().manual_seed((base ^ digest) % 2 ** 63)
                drawn = _draw(scheme, flax_shape, g).numpy()
                p.copy_(to_torch_layout(mod, pname, drawn).to(p.dtype))
            elif leaf == "bias":
                p.zero_()
            elif leaf == "scale" and p.dim() == 1:
                p.fill_(1.0)
    return module
