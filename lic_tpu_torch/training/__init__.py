"""Training: the R-D loss, LR schedules, the train step and loop
(counterpart of ``lic_tpu.training``)."""

from .loss import ms_ssim, msssim_db, rate_distortion_loss, ssim
from .train import (
    POST_PROCESSING_KEYS,
    CodecOptimizer,
    TrainState,
    aux_labels,
    create_state,
    freeze_partition,
    make_optimizer,
    make_train_step,
    partition_labels,
    train,
)

__all__ = [
    "POST_PROCESSING_KEYS",
    "CodecOptimizer",
    "TrainState",
    "aux_labels",
    "create_state",
    "freeze_partition",
    "make_optimizer",
    "make_train_step",
    "ms_ssim",
    "partition_labels",
    "msssim_db",
    "rate_distortion_loss",
    "ssim",
    "train",
]
