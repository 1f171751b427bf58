"""Adam and AdamW with optax's arithmetic, for the trainer.

``torch.optim.Adam`` takes its bias corrections ``1 − β^t`` in float64;
optax takes them in fp32, where ``1 − 0.999^t`` keeps only a few
significant bits at small t, so the two updates differ by up to 1e-5
relative in the first steps.  This optimizer repeats optax's
``scale_by_adam`` (+ ``add_decayed_weights``) + ``scale_by_learning_rate``
+ ``apply_updates`` operation for operation in the parameters' dtype:

    μ ← (1 − β₁)·g + β₁·μ;   ν ← (1 − β₂)·g² + β₂·ν;   t ← t + 1
    u = (μ / (1 − β₁^t)) / (sqrt(ν / (1 − β₂^t)) + ε)  [+ wd·p]
    p ← p + u·(−lr)

with ``β^t`` and the rate rounded to fp32 as optax rounds them.  The step
count is per parameter group (``group["count"]``), as optax keeps one per
transform.  Every update is an in-place ``torch._foreach_*`` op on the
parameters, which moves their version counters.
"""

from __future__ import annotations

import numpy as np
import torch


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      count=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            for p in ps:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in ps]
            nu = [self.state[p]["nu"] for p in ps]
            b1, b2 = group["betas"]
            group["count"] += 1
            t = np.float32(group["count"])
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            c1 = float(np.float32(1) - np.float32(b1) ** t)
            c2 = float(np.float32(1) - np.float32(b2) ** t)
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, -float(np.float32(group["lr"])))
            torch._foreach_add_(ps, upd)
