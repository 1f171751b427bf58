"""The training step and loop (counterpart of ``lic_tpu/training/train.py``).

The objective is ``λ·255²·MSE + bpp`` (or the MS-SSIM form) plus the
EntropyBottleneck's aux loss, whose gradient reaches only the
``quantiles`` (the density MLP is detached there).  ``make_optimizer``
splits the parameters as ``aux_labels`` does: the main group is clipped
to a global norm of ``grad_clip_norm`` and stepped by Adam (AdamW with
``weight_decay > 0``) at the MultiStep rate; the ``quantiles`` take a
separate, unclipped Adam at ``aux_lr`` (CompressAI's aux optimizer).
Both are ``training.adam.Adam``, optax's arithmetic in torch.
``train_step`` applies the update only when every gradient is finite; a
skipped step keeps the parameters and both optimizers' state (and the
schedule's count), but the step and the noise generator still advance.
``train`` is the epoch loop with the 10-step NaN-streak abort, the
``[Epoch %04d TRAIN]`` line and ``train_log.txt``.

Kernels B3/B6 cache their weights' TF32 split; every ``torch.optim``
step drops it (``layers.conv_direct``), so they read the updated weights
on their next call.

Under ``torch.distributed`` pass the model wrapped in
``DistributedDataParallel`` (``parallel.distributed``): each rank takes
its share of the batch and DDP averages the gradients.

Gain-unit models with ``lmbda_list`` train multi-rate: each step draws a
unit k uniformly from [0, K) with the state's own ``rate_generator`` and
optimizes λ_k·255²·D + R at rate k, so one checkpoint learns K operating
points.

Two-phase training of a model with the HAN post-processing tail
(``train_net_unet.py:125-134``): ``freeze_partition`` freezes the group
not being trained, by ``requires_grad``, so autograd records nothing for
it and ``make_optimizer`` leaves it out (no Adam state, no weight decay:
each frozen leaf stays bit for bit).  Phase 1 trains everything but the
tail (``POST_PROCESSING_KEYS``), phase 2 (``post_processing_phase``) the
tail alone, with optax's ``adamw`` defaults (weight decay 1e-4) at the
``pp_milestones`` schedule; its step cuts the gradient at the HAN input
(``stop_base_grad``) and takes the bpp and the aux loss as constants.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch import nn

from ..config import TrainConfig
from ..ops.rounding import uniform_noise
from . import schedule as schedules
from .adam import Adam
from .loss import ms_ssim, rate_distortion_loss

POST_PROCESSING_KEYS = ("han", "conv_weights_gen_han")
# optax.adamw's default decay, which the JAX package's HAN phase takes
PP_WEIGHT_DECAY = 1e-4


def _unwrap(model: nn.Module) -> nn.Module:
    """The codec inside a ``DistributedDataParallel`` wrapper (or the model)."""
    return getattr(model, "module", model)


def aux_labels(model: nn.Module) -> Dict[str, str]:
    """'aux' for the EntropyBottleneck's ``quantiles``, 'main' otherwise,
    by parameter name."""
    return {n: "aux" if n.split(".")[-1] == "quantiles" else "main"
            for n, _ in _unwrap(model).named_parameters()}


def partition_labels(model: nn.Module, post_processing: bool) -> Dict[str, str]:
    """'train' / 'freeze' by parameter name: ``post_processing=False``
    trains everything but the HAN tail (the reference's ``base_params``),
    True the tail alone (``post_processing_params``)."""
    return {n: "train" if (n.split(".")[0] in POST_PROCESSING_KEYS) == post_processing
            else "freeze" for n, _ in _unwrap(model).named_parameters()}


def freeze_partition(model: nn.Module, post_processing: bool) -> Dict[str, str]:
    """Set ``requires_grad`` by ``partition_labels`` (before
    ``make_optimizer``, and before a ``DistributedDataParallel`` wrap):
    no gradient reaches a frozen leaf, and the optimizer does not hold
    it.  → the labels."""
    labels = partition_labels(model, post_processing)
    for n, p in _unwrap(model).named_parameters():
        p.requires_grad_(labels[n] == "train")
    return labels


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    norm is at least ``max_norm`` (optax's ``clip_by_global_norm``)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class CodecOptimizer:
    """The two updates of one step: clip + Adam (AdamW) at the scheduled
    rate on the main group, Adam at ``aux_lr`` on the ``quantiles``.
    ``count`` is the number of updates applied, the schedule's step."""

    def __init__(self, model: nn.Module, train_cfg: TrainConfig, steps_per_epoch: int,
                 post_processing_phase: bool = False):
        labels = aux_labels(model)
        named = [(n, p) for n, p in _unwrap(model).named_parameters() if p.requires_grad]
        self.main_params = [p for n, p in named if labels[n] == "main"]
        self.aux_params = [p for n, p in named if labels[n] == "aux"]
        if post_processing_phase:
            milestones, decay = train_cfg.pp_milestones, PP_WEIGHT_DECAY
        else:
            milestones, decay = train_cfg.lr_milestones, train_cfg.weight_decay
        self.main = Adam(self.main_params, lr=train_cfg.lr, weight_decay=decay)
        # a model without an EntropyBottleneck (or with it frozen) has no
        # aux group
        self.aux = Adam(self.aux_params, lr=train_cfg.aux_lr) if self.aux_params else None
        self.lr = schedules.multistep(train_cfg.lr, milestones, steps_per_epoch,
                                      train_cfg.lr_gamma)
        self.max_norm = train_cfg.grad_clip_norm
        self.count = 0

    def _optimizers(self):
        return [o for o in (self.main, self.aux) if o is not None]

    def zero_grad(self) -> None:
        for o in self._optimizers():
            o.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.main_params + self.aux_params if p.grad is not None]

    def step(self) -> None:
        for group in self.main.param_groups:
            group["lr"] = self.lr(self.count)
        main_grads = [p.grad for p in self.main_params if p.grad is not None]
        if main_grads:
            clip_by_global_norm_(main_grads, self.max_norm)
        for o in self._optimizers():
            o.step()
        self.count += 1

    def step_if_finite(self) -> bool:
        """``step()`` when every gradient is finite, else nothing (the
        parameters, both optimizers' state and ``count`` kept); → whether
        it stepped."""
        grads = self.grads()
        # g·0 is NaN exactly where g is not finite, and a norm carries the
        # NaN: three multi-tensor launches where a check per tensor took
        # four launches each
        finite = not grads or bool(
            torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0))).isfinite().all())
        if finite:
            self.step()
        return finite

    def state_dict(self) -> dict:
        return {"main": self.main.state_dict(),
                "aux": None if self.aux is None else self.aux.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.main.load_state_dict(state["main"])
        if self.aux is not None:
            self.aux.load_state_dict(state["aux"])
        self.count = int(state["count"])


def make_optimizer(model: nn.Module, train_cfg: TrainConfig, steps_per_epoch: int,
                   post_processing_phase: bool = False) -> CodecOptimizer:
    """The optimizer over the parameters that require a gradient (see
    ``freeze_partition``); the HAN phase takes AdamW at the ``pp_milestones``
    schedule."""
    return CodecOptimizer(model, train_cfg, steps_per_epoch, post_processing_phase)


@dataclass
class TrainState:
    model: nn.Module            # the codec, or its DDP wrapper
    optimizer: CodecOptimizer
    generator: torch.Generator  # the noise draws
    rate_generator: torch.Generator  # multi-rate training's unit draws (CPU)
    step: int = 0


def make_train_step(model: nn.Module, train_cfg: TrainConfig,
                    optimizer: CodecOptimizer, post_processing_phase: bool = False) -> Callable:
    """→ ``train_step(state, batch, on_phase=None) -> metrics``.
    ``on_phase(name)``, where given, is called at "start", "forward",
    "backward" and "optimizer" (the end of each phase), for timing.
    With ``train_cfg.lmbda_list`` (gain-unit models, one λ per unit) each
    step trains at a unit drawn from ``state.rate_generator``; the
    metrics' ``rate`` says which.  ``post_processing_phase``: the forward
    cuts the gradient at the HAN input and the bpp and aux loss enter the
    loss as constants (phase 2 trains the tail alone)."""
    gain_units = _unwrap(model).cfg.gain_units
    multi_rate = bool(train_cfg.lmbda_list)
    if multi_rate and gain_units == 0:
        raise ValueError(
            "lmbda_list was given but the model has no gain units — the "
            "run would silently train single-rate at lmbda_list unused"
        )
    if multi_rate and len(train_cfg.lmbda_list) != gain_units:
        raise ValueError(
            f"lmbda_list has {len(train_cfg.lmbda_list)} entries for "
            f"{gain_units} gain units"
        )

    def train_step(state: TrainState, batch: torch.Tensor,
                   on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        mark = on_phase or (lambda name: None)
        mark("start")
        rate, lmbda = None, train_cfg.lmbda
        if multi_rate:
            k = int(torch.randint(gain_units, (), generator=state.rate_generator))
            rate, lmbda = float(k), train_cfg.lmbda_list[k]
        optimizer.zero_grad()
        out = state.model(batch, training=True, noise_fn=uniform_noise(state.generator),
                          rate=rate, stop_base_grad=post_processing_phase)
        msssim = (ms_ssim(out.x_tilde, batch, data_range=2.0)
                  if train_cfg.loss_type != "mse" else None)
        bpp = out.bpp.detach() if post_processing_phase else out.bpp
        loss = rate_distortion_loss(bpp, out.mse, lmbda, train_cfg.loss_type, msssim)
        aux = _unwrap(state.model).entropy_aux_loss()
        if post_processing_phase:
            aux = aux.detach()
        mark("forward")
        (loss + aux).backward()
        mark("backward")
        finite = optimizer.step_if_finite()
        mark("optimizer")
        state.step += 1
        metrics = {"loss": loss.detach(), "bpp": out.bpp.detach(), "mse": out.mse.detach(),
                   "aux": aux.detach(), "skipped": torch.tensor(float(not finite))}
        if multi_rate:
            metrics["rate"] = torch.tensor(rate)
        return metrics

    return train_step


def create_state(model: nn.Module, optimizer: CodecOptimizer, seed: int = 0) -> TrainState:
    """The state at step 0; the noise generator lives on the model's
    device, seeded with ``seed + 2`` (the JAX package's rng seed), the
    rate generator on the CPU, seeded with ``seed + 3``."""
    device = next(_unwrap(model).parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    rate_gen = torch.Generator().manual_seed(seed + 3)
    return TrainState(model=model, optimizer=optimizer, generator=gen, rate_generator=rate_gen)


def train(
    model: nn.Module,
    data_iterator: Iterator[torch.Tensor],
    train_cfg: TrainConfig,
    steps_per_epoch: int,
    checkpoint_dir: Optional[str] = None,
    post_processing_phase: bool = False,
    epochs: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
) -> TrainState:
    """Epoch-structured training as the reference training script runs it: a
    ``[Epoch %04d TRAIN] Loss: … bpp: … mse: …`` line per epoch (and into
    ``checkpoint_dir/train_log.txt``), a checkpoint every
    ``ckpt_every_epochs``; 10 non-finite losses in a row abort.  A model
    with the HAN tail trains one of its two groups (``freeze_partition``;
    ``post_processing_phase`` picks the tail, ``pp_epochs`` by default)."""
    from ..utils.checkpoint import CheckpointManager

    if _unwrap(model).cfg.post_processing:
        freeze_partition(model, post_processing_phase)
    optimizer = make_optimizer(model, train_cfg, steps_per_epoch, post_processing_phase)
    state = create_state(model, optimizer, train_cfg.seed)
    step_fn = make_train_step(model, train_cfg, optimizer, post_processing_phase)
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    n_epochs = epochs or (train_cfg.pp_epochs if post_processing_phase else train_cfg.epochs)
    _unwrap(model).train()
    nan_streak = 0
    for epoch in range(n_epochs):
        acc = {"loss": 0.0, "bpp": 0.0, "mse": 0.0}
        for _ in range(steps_per_epoch):
            metrics = step_fn(state, next(data_iterator))
            loss = float(metrics["loss"])
            if math.isnan(loss):  # the step was skip-guarded if its gradients were
                nan_streak += 1
                if nan_streak >= 10:
                    raise RuntimeError("NaN in loss (10 consecutive steps)")
                continue
            nan_streak = 0
            for k in acc:
                acc[k] += float(metrics[k])
        line = "[Epoch %04d TRAIN] Loss: %.4f bpp: %.4f mse: %.4f" % (
            epoch, acc["loss"] / steps_per_epoch, acc["bpp"] / steps_per_epoch,
            acc["mse"] / steps_per_epoch)
        log_fn(line)
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            with open(os.path.join(checkpoint_dir, "train_log.txt"), "a") as fd:
                fd.write(line + "\n")
        if ckpt and epoch % train_cfg.ckpt_every_epochs == train_cfg.ckpt_every_epochs - 1:
            ckpt.save(state, epoch)
    return state
