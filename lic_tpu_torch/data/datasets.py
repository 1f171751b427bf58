"""Host-side image pipeline for training (counterpart of
``lic_tpu/data/datasets.py``).

A folder (or glob) of images, random ``crop_size`` crops (an image smaller
than the crop is first tiled by symmetric padding), ``x/127.5 − 1``, and a
prefetch of ready batches: ``num_threads`` host threads decode and crop
while the device computes, each thread drawing from its own
``numpy.random.default_rng(seed·1000 + thread)`` as in the JAX package, so
at ``num_threads=1`` the crops are the JAX iterator's.  Batches come out
NCHW in ``channels_last`` memory on the device asked for.  Decoding needs
PIL, imported where it is used: a host without PIL can still import this
module and train on ``synthetic_batches`` or ``data.smooth_images``.
"""

from __future__ import annotations

import glob
import os
import queue
import sys
import threading
from typing import Iterator, List

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(path: str) -> List[str]:
    if os.path.isdir(path):
        files = []
        for ext in IMG_EXTS:
            files += glob.glob(os.path.join(path, f"*{ext}"))
            files += glob.glob(os.path.join(path, f"*{ext.upper()}"))
        return sorted(files)
    return sorted(glob.glob(path))


def load_image_uint8(path: str) -> np.ndarray:
    """(H, W, 3) uint8."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PIL unavailable: cannot decode images") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def normalize_pm1(x: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] → float32 [−1, 1] (``train_net_unet.py:43-51``)."""
    return x.astype(np.float32) / 127.5 - 1.0


class ImageFolderDataset:
    """Folder of images with random crops for training."""

    def __init__(self, path: str, crop_size: int = 256):
        self.files = list_images(path)
        if not self.files:
            raise FileNotFoundError(f"no images under {path}")
        self.crop_size = crop_size

    def __len__(self) -> int:
        return len(self.files)

    def sample_crop(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        """A random (crop, crop, 3) uint8 crop of image ``idx``."""
        img = load_image_uint8(self.files[idx])
        c = self.crop_size
        h, w = img.shape[:2]
        while h < c or w < c:
            # 'symmetric' takes pad widths up to the whole side, and the
            # loop covers images of any size
            img = np.pad(img, ((0, min(h, max(0, c - h))), (0, min(w, max(0, c - w))), (0, 0)),
                         mode="symmetric")
            h, w = img.shape[:2]
        top = int(rng.integers(0, h - c + 1))
        left = int(rng.integers(0, w - c + 1))
        return img[top : top + c, left : left + c]


def to_batch(nhwc: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, 3) float32 → NCHW ``channels_last`` on ``device`` (the
    same bytes)."""
    t = torch.from_numpy(np.ascontiguousarray(nhwc)).permute(0, 3, 1, 2)
    return t.to(device, non_blocking=True)


def train_iterator(
    dataset: ImageFolderDataset,
    batch_size: int,
    seed: int = 0,
    num_threads: int = 4,
    prefetch: int = 4,
    device="cuda",
) -> Iterator[torch.Tensor]:
    """Infinite iterator of (B, 3, crop, crop) float32 batches in [−1, 1],
    ``channels_last`` on ``device``.  A thread skips an unreadable file
    and gives up (with a message) only after ``max(10·n, 100)`` failures
    in a row.  Closing the iterator stops the threads."""
    q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker(tid: int):
        rng = np.random.default_rng(seed * 1000 + tid)
        n = len(dataset)
        failures = 0
        while not stop.is_set():
            crops = []
            while len(crops) < batch_size and not stop.is_set():
                try:
                    crops.append(normalize_pm1(dataset.sample_crop(int(rng.integers(0, n)), rng)))
                    failures = 0
                except (OSError, ValueError, RuntimeError) as e:  # an unreadable file
                    failures += 1
                    if failures >= max(10 * n, 100):
                        print(f"prefetch worker {tid}: {failures} consecutive unreadable "
                              f"samples, giving up: {e}", file=sys.stderr)
                        return
            if len(crops) < batch_size:
                return  # stopping
            batch = np.stack(crops)
            while not stop.is_set():
                try:
                    q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(num_threads)]
    for t in threads:
        t.start()
    try:
        while True:
            while True:
                try:
                    batch = q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError("every prefetch worker gave up") from None
            yield to_batch(batch, device)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)


def synthetic_batches(batch_size: int, crop: int = 256, seed: int = 0,
                      device="cuda") -> Iterator[torch.Tensor]:
    """Deterministic U(−1, 1) batches (the JAX package's draws, NCHW) for
    tests and benchmarks without a dataset."""
    rng = np.random.default_rng(seed)
    while True:
        yield to_batch(rng.uniform(-1, 1, (batch_size, crop, crop, 3)).astype(np.float32),
                       device)
