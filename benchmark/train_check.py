"""The check of the ``train`` cells: the program's first steps against the
plain reference's.

The reference (in float64) starts from the same weights, works out the same crops again
from the raw images and the input pipeline's seeds (``train_iterator``
draws each thread's crops from ``numpy.random.default_rng(seed·1000 +
thread)``; which thread's batch came first is a race, so each of the
program's batches is matched to the one candidate whose crops it equals),
draws its noise from its own generator seeded as the trainer seeds its
own (``seed + 2``, on the device), and takes the same steps: the loss
``λ·255²·MSE + bpp`` plus the entropy bottleneck's aux loss, the main
group's gradient clipped to a global norm of 1 and Adam at 1e-4 (optax's
arithmetic), the quantiles' Adam at 1e-3.

Three numbers are compared, each as a gap between the program's reading
and the reference's:

* ``loss_rel``: the worst of the first steps' losses, |ΔL| / |L|;
* ``grad_gap``: the first gradient as the optimizer got it (the program's
  from its Adam state after one step, μ / (1 − β₁)), by the worst leaf:
  |‖g_prog‖ − ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
* ``change_gap``: each leaf's change after the checked steps, by the worst
  leaf as above; leaves whose reference gradient is under a thousandth of
  the median leaf's are left out, since Adam moves them by round-off.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import system

BETAS = (0.9, 0.999)
EPS = 1e-8
LR, AUX_LR, CLIP = 1e-4, 1e-3, 1.0
SMALL_LEAF = 1e-3


class ProgramReadings:
    """What the program's first steps leave: its batches and losses, each
    leaf's first gradient norm and its change after the checked steps."""

    def __init__(self, model, optimizer, weights: Dict[str, torch.Tensor]):
        self.model, self.optimizer, self.weights = model, optimizer, weights
        self.batches: List[torch.Tensor] = []
        self.losses: List[float] = []
        self.grad_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}

    def _named(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def read_first_gradient(self) -> None:
        groups = [self.optimizer.main] + ([self.optimizer.aux] if self.optimizer.aux else [])
        state = {}
        for g in groups:
            state.update({id(p): s for p, s in g.state.items()})
        for n, p in self._named():
            s = state.get(id(p))
            mu = s["mu"] if s else torch.zeros_like(p)
            self.grad_norms[n] = float(torch.linalg.vector_norm(mu.double())) / (1 - BETAS[0])

    def read_change(self) -> None:
        with torch.no_grad():
            for n, p in self._named():
                self.change_norms[n] = float(
                    torch.linalg.vector_norm((p.double() - self.weights[n].double())))


def candidate_batches(pixels: np.ndarray, p: dict, seed: int, per_thread: int):
    """Each input thread's first batches, as ``train_iterator`` cuts them:
    → {(thread, k): (B, 3, crop, crop) float32}."""
    n, h, w, _ = pixels.shape
    c, b = int(p["crop"]), int(p["batch"])
    out = {}
    for tid in range(int(p["threads"])):
        rng = np.random.default_rng(seed * 1000 + tid)
        for k in range(per_thread):
            crops = []
            for _ in range(b):
                idx = int(rng.integers(0, n))
                top, left = int(rng.integers(0, h - c + 1)), int(rng.integers(0, w - c + 1))
                crops.append(pixels[idx, top: top + c, left: left + c].astype(np.float32)
                             / 127.5 - 1.0)
            out[(tid, k)] = torch.from_numpy(np.stack(crops)).permute(0, 3, 1, 2)
    return out


def match_batches(batches: List[torch.Tensor], candidates) -> List[torch.Tensor]:
    """The reference's own crops for each of the program's batches; None
    where the program's batch equals none of them."""
    out = []
    for x in batches:
        hit = [v for v in candidates.values() if v.shape == x.shape and torch.equal(v, x)]
        out.append(hit[0] if hit else None)
    return out


def reference_steps(config, weights, batches, seed: int, lmbda: float, device,
                    precision: str = "") -> ProgramReadings:
    """The plain reference's steps on ``batches`` (in float64, or the
    control's TF32); its readings in the program's form.  Its noise is
    drawn in fp32, as the program draws it, then widened."""
    ref = system.build_reference(config, weights, device, precision).train()
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    def noise(shape, dtype, dev):
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32, device=dev) - 0.5
        return u.to(dtype)

    named = list(ref.named_parameters())
    main = [(n, q) for n, q in named if n.split(".")[-1] != "quantiles"]
    aux = [(n, q) for n, q in named if n.split(".")[-1] == "quantiles"]
    mu = {n: torch.zeros_like(q) for n, q in named}
    nu = {n: torch.zeros_like(q) for n, q in named}
    readings = ProgramReadings(ref, None, weights)
    for t, x in enumerate(batches, start=1):
        for _, q in named:
            q.grad = None
        out = ref(x.to(device, ref.dtype).contiguous(memory_format=torch.channels_last),
                  training=True, noise_fn=noise)
        loss = lmbda * 255.0 ** 2 * out["mse"] + out["bpp"]
        (loss + ref.entropy_bottleneck.aux_loss()).backward()
        readings.losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {n: q.grad for n, q in named}
            if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
                continue
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(grads[n]) for n, _ in main]))
            if norm >= CLIP:
                for n, _ in main:
                    grads[n] = grads[n] * (CLIP / norm)
            if t == 1:
                readings.grad_norms = {n: float(torch.linalg.vector_norm(g.double()))
                                       for n, g in grads.items()}
            c1 = float(np.float32(1) - np.float32(BETAS[0]) ** np.float32(t))
            c2 = float(np.float32(1) - np.float32(BETAS[1]) ** np.float32(t))
            for group, lr in ((main, LR), (aux, AUX_LR)):
                for n, q in group:
                    g = grads[n]
                    mu[n] = BETAS[0] * mu[n] + (1 - BETAS[0]) * g
                    nu[n] = BETAS[1] * nu[n] + (1 - BETAS[1]) * g * g
                    u = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS)
                    q.add_(u * -float(np.float32(lr)))
    readings.read_change()
    del ref
    torch.cuda.empty_cache()
    system.fp32_numerics()
    return readings


NAMES = ("loss_rel", "grad_gap", "change_gap", "grad_median_gap", "change_median_gap")


def gaps(prog: ProgramReadings, ref: ProgramReadings) -> Dict[str, float]:
    """The numbers compared (see the module's docstring)."""
    loss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog.losses, ref.losses))
    if len(prog.losses) != len(ref.losses):
        loss = float("inf")
    g_ref = ref.grad_norms
    med_g = float(np.median(list(g_ref.values())))
    grad = [abs(prog.grad_norms.get(n, 0.0) - v) / max(v, med_g, 1e-30)
            for n, v in g_ref.items()]
    moved = {n: v for n, v in ref.change_norms.items() if g_ref[n] >= SMALL_LEAF * med_g}
    med_c = float(np.median(list(moved.values())))
    change = [abs(prog.change_norms.get(n, 0.0) - v) / max(v, med_c, 1e-30)
              for n, v in moved.items()]
    return {"loss_rel": loss, "grad_gap": max(grad), "change_gap": max(change),
            "grad_median_gap": float(np.median(grad)),
            "change_median_gap": float(np.median(change)),
            "leaves_left_out": float(len(ref.change_norms) - len(moved))}


def check(config, weights, program: ProgramReadings, pixels, p: dict, seed: int, device):
    """→ (checks, readings) of a run: each number against the
    configuration's limit."""
    cands = candidate_batches(pixels, p, seed, per_thread=len(program.batches) + 2)
    ref_batches = match_batches(program.batches, cands)
    limits = config["limits"]
    if any(x is None for x in ref_batches):
        found = {k: float("inf") for k in NAMES}
    else:
        found = gaps(program, reference_steps(config, weights, ref_batches, seed,
                                              float(p["lmbda"]), device))
    checks = [{"name": k, "value": found[k], "limit": float(limits[k]),
               "ok": found[k] <= float(limits[k])} for k in NAMES if k in limits]
    return checks, {"program_losses": program.losses,
                    "leaves_left_out": found.get("leaves_left_out")}
