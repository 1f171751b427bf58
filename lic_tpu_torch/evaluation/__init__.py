"""Evaluation (counterpart of ``lic_tpu.evaluation``): metrics in the
0..255 domain, per-image evaluation of a folder, and content-adaptive
encoding."""

from .eval import content_adaptive_finetune, evaluate_folder, evaluate_image
from .metrics import mse_255, psnr_255, to_255

__all__ = [
    "content_adaptive_finetune",
    "evaluate_folder",
    "evaluate_image",
    "mse_255",
    "psnr_255",
    "to_255",
]
