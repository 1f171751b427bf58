"""Fully-factorized learned entropy model (EntropyBottleneck), eval side.

Counterpart of ``lic_tpu/entropy/factorized.py:32-163``: the per-channel
monotone MLP (softplus matrices, tanh factors), the eval-mode
medians-offset rounding and likelihood, ``medians`` and ``pmf_table``.
The noise quantization and the aux loss come with training.  Parameter
names, shapes and inits are the JAX module's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bounds import lower_bound

_FILTERS = (3, 3, 3, 3)
_INIT_SCALE = 10.0
_LIKELIHOOD_BOUND = 1e-9


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

    def _logits_cumulative(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: (C, 1, N) → logits (C, 1, N)."""
        logits = inputs
        for i in range(self.n_layers):
            matrix = F.softplus(getattr(self, f"matrix_{i}"))
            logits = torch.matmul(matrix, logits) + getattr(self, f"bias_{i}")
            if i < self.n_layers - 1:
                factor = torch.tanh(getattr(self, f"factor_{i}"))
                logits = logits + factor * torch.tanh(logits)
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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval mode.  x: (B, C, H, W) → (outputs, likelihood), both NCHW."""
        b, c, h, w = x.shape
        perm = x.permute(1, 0, 2, 3).reshape(c, 1, -1)  # channel-major
        medians = self.quantiles[:, :, 1:2]
        outputs = torch.round(perm - medians) + medians
        lik = lower_bound(self._likelihood(outputs), _LIKELIHOOD_BOUND)

        def back(t):
            return t.reshape(c, b, h, w).permute(1, 0, 2, 3)

        return back(outputs), back(lik)

    def pmf_table(self, min_sym: int, max_sym: int) -> torch.Tensor:
        """Per-channel PMF over integer symbols ``[min_sym, max_sym]``
        relative to the channel median → (C, S)."""
        dev = self.quantiles.device
        symbols = torch.arange(min_sym, max_sym + 1, device=dev).float()
        samples = symbols[None, None, :] + self.quantiles[:, :, 1:2]
        return self._likelihood(samples)[:, 0, :]
