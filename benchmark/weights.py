"""Weights from the run's seed, the same for the program and the reference.

One ``torch.randn`` call on the device draws every value; each leaf then
takes its slice, scaled by a rule of its module's kind:

* conv, transposed conv, sub-pixel conv and linear weights: N(0, 1/fan_in)
  (fan_in of a transposed conv's (in, out, k, k) weight is in·k·k); the
  last layer of each residual or attention branch, which the program
  initialises to zero, ``BRANCH_GAIN`` times that, so every branch
  computes and the stacks of gates stay well conditioned (at 1 the
  flagship's WAM gates amplify a 1e-6 change to 1e-3);
* biases N(0, 0.02²); LayerNorm scales 1 + N(0, 0.05²);
* a generated conv's head (the reference class's ``GENERATOR_HEADS``):
  the program's own scale, N(0, 0.01/fan_avg) and a bias of N(0, 0.2²),
  which keeps the reconstruction's tanh out of saturation;
* GDN β = 1 + 0.1·|n| and Γ = 0.01·I + 0.0002·|n|, stored in the
  non-negative parametrization (at the program's 0.1·I four IGDNs in a
  row raise a map of spread 5 to 1e6, and the output's tanh saturates);
* relative-position tables N(0, 0.1²);
* the class's ``LATENT_LEAF`` (g_a's last conv) ``latent_gain`` times its
  rule, and the biases of its σ heads (``SIGMA_BIASES``) ``SIGMA_BIAS``
  more: a σ at the 0.11 floor makes every symbol escape its table.
  ``latent_gain`` is the configuration file's: it is set so that the
  seeded images code at the bits per pixel that the configuration's codec,
  trained at λ 0.0025, reaches on a held-out photograph, so the host coder
  has a trained codec's load.
* the entropy bottlenecks (``BOTTLENECKS``): their initial matrices for a
  density of scale ``EB_SCALE`` plus N(0, 0.1²), biases and factors
  N(0, 0.3²) (a trained model's factors are not zero), quantiles
  (−``EB_SCALE``, 0, ``EB_SCALE``) shifted per channel by N(0, 0.3²), so
  z is rounded about medians that are not integers.  ``EB_SCALE`` is
  about twice z's spread
  (0.08-0.17), as a fitted bottleneck's; at the init's 10, each z element
  costs 5.5 bits and the flagship's z alone more than its trained total;
* last, the class's ``leaf_rule``, a rule of its own for a leaf of its own.

The reference class declares every model-specific leaf by name, so a new
model is a reference class of its own and no edit here.
"""

from __future__ import annotations

import math
from fnmatch import fnmatchcase
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .reference import layers as L

_PEDESTAL = (2 ** -18) ** 2
BRANCH_GAIN = 0.3
SIGMA_BIAS = 0.3
EB_SCALE = 0.3


def _stored(v: torch.Tensor) -> torch.Tensor:
    """The non-negative parametrization's stored value for ``v``."""
    return torch.sqrt(torch.clamp(v + _PEDESTAL, min=_PEDESTAL))


def _leaves(ref: nn.Module) -> Iterator[Tuple[str, nn.Module, str, torch.Tensor]]:
    for mod_name, mod in ref.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{p_name}" if mod_name else p_name), mod, p_name, p


def _rule(mod: nn.Module, p_name: str, shape, n: torch.Tensor,
          head: bool, bottleneck: bool) -> torch.Tensor:
    """The leaf's value from ``n`` (standard normal draws of its shape)."""
    if bottleneck:
        if p_name.startswith("matrix_"):
            scale = EB_SCALE ** (1.0 / mod.n_layers)
            return math.log(math.expm1(1.0 / scale / shape[1])) + 0.1 * n
        if p_name == "quantiles":
            base = torch.tensor([-EB_SCALE, 0.0, EB_SCALE], device=n.device)
            return base + 0.3 * n[:, :, 1:2]
        return 0.3 * n  # bias_i, factor_i
    if isinstance(mod, L.GDN):
        if p_name == "beta":
            return _stored(1.0 + 0.1 * n.abs())
        eye = torch.eye(shape[0], device=n.device)
        return _stored(0.01 * eye + 0.0002 * n.abs())
    if isinstance(mod, nn.LayerNorm):
        return 1.0 + 0.05 * n if p_name == "weight" else 0.02 * n
    if p_name in ("relative_position_bias_table", "relative_position_params"):
        return 0.1 * n
    if head:
        fan_avg = (shape[1] + shape[0]) / 2 if p_name == "weight" else None
        return n * math.sqrt(0.01 / fan_avg) if p_name == "weight" else 0.2 * n
    if p_name == "bias":
        return 0.02 * n
    numel = int(np.prod(shape))
    fan_in = numel // shape[1] if isinstance(mod, L.ConvTranspose2d) else numel // shape[0]
    return n / math.sqrt(fan_in)


# (module kind, child) of each branch's last layer, zero-init in the program
_BRANCH_ENDS = ((L.ResidualBlock, "conv2"), (L.ResidualBlock3_5, "conv3"),
                (L.ResidualBlock5x5, "conv"), (L.ResidualUnit, "conv3"),
                (L.ResidualBottleneck, "conv3"), (L.ResidualBlockWithStride, "conv2"),
                (L.WindowAttention, "proj"), (L.WMSA, "linear"),
                (L.SwinTransformerBlock, "mlp_fc2"))


def make_weights(ref: nn.Module, seed: int, device, latent_gain: float
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``ref``, a reference class's model (by its state-dict
    name), from ``seed``: one draw on ``device``, fp32."""
    leaves = list(_leaves(ref))
    total = sum(p.numel() for *_, p in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    heads = {id(ref.get_submodule(m)) for m in ref.GENERATOR_HEADS}
    bottlenecks = {id(ref.get_submodule(m)) for m in ref.BOTTLENECKS}
    ends = {id(getattr(m, child)) for m in ref.modules() for cls, child in _BRANCH_ENDS
            if isinstance(m, cls)}
    out, off = {}, 0
    with torch.no_grad():
        for name, mod, p_name, p in leaves:
            n = flat[off: off + p.numel()].view(p.shape)
            off += p.numel()
            v = _rule(mod, p_name, tuple(p.shape), n, id(mod) in heads,
                      id(mod) in bottlenecks)
            if p_name == "weight" and id(mod) in ends:
                v = v * BRANCH_GAIN
            if name == ref.LATENT_LEAF:
                v = v * latent_gain
            elif any(fnmatchcase(name, pat) for pat in ref.SIGMA_BIASES):
                v = v + SIGMA_BIAS
            out[name] = ref.leaf_rule(name, v).contiguous()
    return out


def load(module: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s leaves of the same names (every
    weight must find its leaf; leaves of the module that the reference
    does not have keep their values and are reported by the caller)."""
    params = dict(module.named_parameters())
    missing = [k for k in weights if k not in params]
    if missing:
        raise KeyError(f"the module has no leaves {missing[:5]} ({len(missing)} in all)")
    with torch.no_grad():
        for k, v in weights.items():
            if params[k].shape != v.shape:
                raise ValueError(f"{k}: shape {tuple(params[k].shape)} against {tuple(v.shape)}")
            params[k].copy_(v)
