"""Data helpers (counterpart of ``lic_tpu.data``): padding, synthetic
images made from a seed, and the training image pipeline."""

from .datasets import (
    ImageFolderDataset,
    list_images,
    load_image_uint8,
    normalize_pm1,
    synthetic_batches,
    train_iterator,
)
from .pad import pad_to_multiple, padded_size, unpad
from .synthetic import smooth_images

__all__ = [
    "ImageFolderDataset",
    "list_images",
    "load_image_uint8",
    "normalize_pm1",
    "pad_to_multiple",
    "padded_size",
    "smooth_images",
    "synthetic_batches",
    "train_iterator",
    "unpad",
]
