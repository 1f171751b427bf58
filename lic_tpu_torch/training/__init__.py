"""Training: the R-D loss, LR schedules, the train step and loop
(counterpart of ``lic_tpu.training``)."""

from .loss import ms_ssim, msssim_db, rate_distortion_loss, ssim
from .train import (
    CodecOptimizer,
    TrainState,
    aux_labels,
    create_state,
    make_optimizer,
    make_train_step,
    train,
)

__all__ = [
    "CodecOptimizer",
    "TrainState",
    "aux_labels",
    "create_state",
    "make_optimizer",
    "make_train_step",
    "ms_ssim",
    "msssim_db",
    "rate_distortion_loss",
    "ssim",
    "train",
]
