"""Fully-factorized learned entropy model (EntropyBottleneck).

Counterpart of ``lic_tpu/entropy/factorized.py:32-163``: the per-channel
monotone MLP (softplus matrices, tanh factors), the eval-mode
medians-offset rounding, the train-time U(-½, ½) noise, the likelihood,
``medians``, ``aux_loss`` and ``pmf_table``.  Parameter names, shapes and
inits are the JAX module's.

The likelihoods of the forward use torch's ops, within 1e-4 of JAX's.
``pmf_table`` feeds the coder's quantized CDFs and the ``.ltc`` digest,
so it must be JAX's table bit for bit: it runs on the host in numpy, with
``xla_f32``'s copies of what XLA's CPU backend computes, whatever the
module's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bounds import lower_bound
from ..ops.rounding import NoiseFn
from . import xla_f32 as xf

_FILTERS = (3, 3, 3, 3)
_INIT_SCALE = 10.0
_LIKELIHOOD_BOUND = 1e-9
_TAIL_MASS = 1e-9


class EntropyBottleneck(nn.Module):
    def __init__(
        self, channels: int, *, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.channels = c = channels
        self.n_layers = len(_FILTERS) + 1
        dims = (1,) + _FILTERS + (1,)
        scale = _INIT_SCALE ** (1.0 / self.n_layers)
        for i in range(self.n_layers):
            mat_init = float(np.log(np.expm1(1.0 / scale / dims[i + 1])))
            self.register_parameter(
                f"matrix_{i}",
                nn.Parameter(torch.full((c, dims[i + 1], dims[i]), mat_init)),
            )
            bias = torch.rand((c, dims[i + 1], 1), generator=generator) - 0.5
            self.register_parameter(f"bias_{i}", nn.Parameter(bias))
            if i < len(_FILTERS):
                self.register_parameter(
                    f"factor_{i}",
                    nn.Parameter(torch.zeros((c, dims[i + 1], 1))),
                )
        q = torch.tensor([-_INIT_SCALE, 0.0, _INIT_SCALE])
        self.quantiles = nn.Parameter(q.repeat(c, 1, 1))  # (C, 1, 3)

    def _logits_cumulative(self, inputs: torch.Tensor, detach: bool = False) -> torch.Tensor:
        """inputs: (C, 1, N) → logits (C, 1, N); ``detach`` stops the
        gradient into the density MLP (the aux loss trains ``quantiles``
        only)."""
        p = lambda name: getattr(self, name).detach() if detach else getattr(self, name)
        logits = inputs
        for i in range(self.n_layers):
            logits = torch.matmul(F.softplus(p(f"matrix_{i}")), logits) + p(f"bias_{i}")
            if i < self.n_layers - 1:
                logits = logits + torch.tanh(p(f"factor_{i}")) * torch.tanh(logits)
        return logits

    @property
    def medians(self) -> torch.Tensor:
        """Per-channel median offsets, shape (C,)."""
        return self.quantiles[:, 0, 1]

    def _likelihood(self, values: torch.Tensor) -> torch.Tensor:
        v0 = self._logits_cumulative(values - 0.5)
        v1 = self._logits_cumulative(values + 0.5)
        sign = -torch.sign(v0 + v1)
        return torch.abs(torch.sigmoid(sign * v1) - torch.sigmoid(sign * v0))

    def forward(
        self, x: torch.Tensor, training: bool = False, noise_fn: Optional[NoiseFn] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C, H, W) → (outputs, likelihood), both NCHW.  Eval: the
        medians-offset rounding; training: x + U(-½, ½), the noise drawn
        by ``noise_fn`` in the channel-major (C, 1, B·H·W) layout."""
        b, c, h, w = x.shape
        perm = x.permute(1, 0, 2, 3).reshape(c, 1, -1)  # channel-major
        if training:
            if noise_fn is None:
                raise ValueError("EntropyBottleneck(training=True) needs a noise_fn")
            outputs = perm + noise_fn(perm.shape, perm.dtype, perm.device)
        else:
            medians = self.quantiles[:, :, 1:2].detach()
            outputs = torch.round(perm - medians) + medians
        lik = lower_bound(self._likelihood(outputs), _LIKELIHOOD_BOUND)

        def back(t):
            return t.reshape(c, b, h, w).permute(1, 0, 2, 3)

        return back(outputs), back(lik)

    def aux_loss(self) -> torch.Tensor:
        """Σ |logits(quantiles) − (−t, 0, t)|, t = log(2 / tail_mass − 1):
        trains the tail quantiles, with the density MLP detached."""
        logits = self._logits_cumulative(self.quantiles, detach=True)
        t = float(np.log(2.0 / _TAIL_MASS - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype, device=logits.device)
        return torch.sum(torch.abs(logits - target))

    def pmf_table(self, min_sym: int, max_sym: int) -> torch.Tensor:
        """Per-channel PMF over integer symbols ``[min_sym, max_sym]``
        relative to the channel median → (C, S) float32 on the CPU,
        JAX's ``pmf_table`` bit for bit (``xla_pmf_table``)."""
        host = {k: v.detach().float().cpu().numpy() for k, v in self.named_parameters()}
        return torch.from_numpy(xla_pmf_table(host, self.n_layers, min_sym, max_sym))


def _xla_logits_cumulative(p: dict, n_layers: int, x: np.ndarray) -> np.ndarray:
    """``_logits_cumulative`` as eager JAX computes it on the CPU, each
    operation rounded on its own (``lic_tpu/entropy/factorized.py:81-97``)."""
    for i in range(n_layers):
        x = xf.add(xf.einsum_cij_cjn(xf.softplus(p[f"matrix_{i}"]), x), xf.f32(p[f"bias_{i}"]))
        if i < n_layers - 1:
            x = xf.add(x, xf.mul(xf.tanh(p[f"factor_{i}"]), xf.tanh(x)))
    return x


def xla_pmf_table(p: dict, n_layers: int, min_sym: int, max_sym: int) -> np.ndarray:
    """The EB's pmf table from its parameters (numpy, by name) as
    ``lic_tpu/entropy/factorized.py:151-163`` computes it under eager JAX
    on the CPU: (C, S) float32, bit for bit."""
    symbols = np.arange(min_sym, max_sym + 1, dtype=np.float32)
    samples = xf.add(symbols[None, None, :], xf.f32(p["quantiles"][:, :, 1:2]))
    v0 = _xla_logits_cumulative(p, n_layers, xf.sub(samples, np.float32(0.5)))
    v1 = _xla_logits_cumulative(p, n_layers, xf.add(samples, np.float32(0.5)))
    sign = -np.sign(xf.add(v0, v1))
    pmf = np.abs(xf.sub(xf.sigmoid(xf.mul(sign, v1)), xf.sigmoid(xf.mul(sign, v0))))
    return pmf[:, 0, :]
